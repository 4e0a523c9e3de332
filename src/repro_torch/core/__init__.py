"""The paper's systems core, ported: the ping-pong schedule and the
disaggregated decode runtime on two CUDA streams."""
