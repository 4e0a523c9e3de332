"""Model FLOPs that a window's tokens need (``step_mfu``).

Per token and layer: the q, k, v and o projections, the router, the
top-k routed experts' gated MLPs (3 matrices each), the dense residual's
where the configuration has one, and attention over the token's real
context (4 H hd per earlier position and itself).  A decode token adds
the LM head; a prompt adds its tokens' layers, causal attention over
each one's prefix, and one LM head for the first token it yields.
"""
from __future__ import annotations


def per_token_linear(cfg: dict) -> float:
    d, H, Hkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], cfg["head_dim"])
    E, K, f = (cfg["num_local_experts"], cfg["num_experts_per_tok"],
               cfg["intermediate_size"])
    fd = cfg.get("dense_residual_size", 0)
    proj = 2 * d * (H + 2 * Hkv) * hd + 2 * H * hd * d
    return proj + 2 * d * E + K * 6 * d * f + 6 * d * fd


def step_flops(cfg: dict, steps) -> float:
    L = cfg["num_hidden_layers"]
    H, hd = cfg["num_attention_heads"], cfg["head_dim"]
    lin, head = per_token_linear(cfg), 2 * cfg["hidden_size"] * cfg["vocab_size"]
    total = 0.0
    for s in steps:
        for T in s.admitted:
            total += L * (T * lin + 2.0 * H * hd * T * (T + 1)) + head
        for valid in s.rows.values():
            total += L * (lin + 4.0 * H * hd * valid) + head
    return total
