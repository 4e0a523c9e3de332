"""Continuous-batching serving engine of the port (contiguous KV cache,
inline prefill; monolithic and ping-pong decode)."""
