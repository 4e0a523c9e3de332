"""Transformer assembly for the ``attn``/``local`` layer kinds.

Parameters are a dict ``{"embed", "final_norm", ["lm_head"], "layers"}``
where ``layers`` is a list of per-layer dicts in execution order (the
JAX package stacks repeated blocks and scans them; here a Python loop
walks the list).  The decode cache is a list of per-layer dicts
``{"k": (B, W, Hkv, hd), "v": ..., "pos": (B, W) int32}``.

Public entry points:
  init_params(cfg, seed, dtype, device)          -> params
  init_cache(cfg, batch, max_seq, dtype, device) -> cache
  prefill(params, cfg, tokens, max_seq)          -> (last_logits, cache)
  decode_step(params, cfg, tokens, cache, pos)   -> (logits, cache)

``decode_step`` writes the new K/V token into the cache in place (the
JAX package rebuilt the cache functionally); callers that slice a cache
along the batch axis get views, so per-micro-batch writes land in the
full cache with no merge.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.config import SUPPORTED_KINDS, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import apply_rope, dense_init, rms_norm, softcap
from repro_torch.models.ffn import gated_ffn
from repro_torch.models.moe import moe_ffn


def _check_kinds(cfg: ModelConfig):
    for kind in cfg.layer_kinds:
        if kind not in SUPPORTED_KINDS:
            raise NotImplementedError(
                f"the port serves layer kinds {SUPPORTED_KINDS}; {cfg.name} "
                f"has {kind!r}")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _init_ffn(gen, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    init = lambda shape, dt=dtype, **kw: dense_init(gen, shape, dt, device, **kw)
    if cfg.moe is not None:
        m = cfg.moe
        p = {
            "router": init((d, m.n_experts), torch.float32),   # router stays f32
            "we1": init((m.n_experts, d, m.d_ff_expert)),
            "we3": init((m.n_experts, d, m.d_ff_expert)),
            "we2": init((m.n_experts, m.d_ff_expert, d)),
        }
        if m.n_shared_experts:
            p.update({"ws1": init((d, m.d_ff_shared)),
                      "ws3": init((d, m.d_ff_shared)),
                      "ws2": init((m.d_ff_shared, d)),
                      "shared_gate": init((d,), torch.float32, scale=0.02)})
        if m.d_ff_dense_residual:
            p.update({"wd1": init((d, m.d_ff_dense_residual)),
                      "wd3": init((d, m.d_ff_dense_residual)),
                      "wd2": init((m.d_ff_dense_residual, d))})
        return p
    return {"w1": init((d, cfg.d_ff)), "w3": init((d, cfg.d_ff)),
            "w2": init((cfg.d_ff, d))}


def init_layer_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    init = lambda shape: dense_init(gen, shape, dtype, device)
    zeros = lambda: torch.zeros(d, dtype=dtype, device=device)
    p = {"ln1": zeros(), "ln2": zeros()}
    if cfg.use_post_norm:
        p["ln1_post"] = zeros()
        p["ln2_post"] = zeros()
    p.update({"wq": init((d, cfg.n_heads * hd)),
              "wk": init((d, cfg.n_kv_heads * hd)),
              "wv": init((d, cfg.n_kv_heads * hd)),
              "wo": init((cfg.n_heads * hd, d))})
    p.update(_init_ffn(gen, cfg, dtype, device))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Random weights from ``seed`` (truncated-normal fan-in init; norms
    zero, since RMSNorm scales by 1 + scale).  Draws with a
    ``torch.Generator`` on ``device``, so the weights never cross the
    host link."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    params = {"embed": dense_init(gen, (cfg.vocab, d), dtype, dev, scale=0.02),
              "final_norm": torch.zeros(d, dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab), dtype, dev)
    params["layers"] = [init_layer_params(gen, cfg, dtype, dev)
                        for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    return min(cfg.window, max_seq) if kind == "local" else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda") -> List[dict]:
    _check_kinds(cfg)
    dev = resolve_device(device)
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = []
    for kind in cfg.layer_kinds:
        W = cache_len(cfg, kind, max_seq)
        cache.append({
            "k": torch.zeros((batch, W, Hkv, hd), dtype=dtype, device=dev),
            "v": torch.zeros((batch, W, Hkv, hd), dtype=dtype, device=dev),
            "pos": torch.full((batch, W), -1, dtype=torch.int32, device=dev)})
    return cache


# ---------------------------------------------------------------------------
# sequence mode (prefill)
# ---------------------------------------------------------------------------


def _maybe_post(p, name, y, cfg):
    return rms_norm(y, p[name]) if cfg.use_post_norm else y


def _ffn_sublayer(p, x, cfg: ModelConfig, capacity_mode: str):
    """x: (B, T, d) -> delta."""
    B, T, d = x.shape
    h = rms_norm(x, p["ln2"])
    if cfg.moe is not None:
        y = moe_ffn(p, h.reshape(B * T, d), cfg.moe, cfg.act,
                    capacity_mode).reshape(B, T, d)
    else:
        y = gated_ffn(h, p["w1"], p["w3"], p["w2"], cfg.act)
    return _maybe_post(p, "ln2_post", y, cfg)


def _self_attn_sublayer(p, x, cfg: ModelConfig, positions, *, window: int,
                        cache_len: int):
    """Returns (delta, cache entry of ring width ``cache_len``)."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    h = rms_norm(x, p["ln1"])
    q = apply_rope((h @ p["wq"]).reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = apply_rope((h @ p["wk"]).reshape(B, T, Hkv, hd), positions, cfg.rope_theta)
    v = (h @ p["wv"]).reshape(B, T, Hkv, hd)
    out = attn_lib.attention(q, k, v, positions, positions, window=window,
                             attn_softcap=cfg.attn_softcap)
    delta = _maybe_post(p, "ln1_post", out.reshape(B, T, H * hd) @ p["wo"], cfg)
    W = cache_len
    n_keep = min(T, W)
    slots = (positions[0, T - n_keep:] % W).long()
    k_c = k.new_zeros((B, W, Hkv, hd))
    v_c = v.new_zeros((B, W, Hkv, hd))
    pos_c = torch.full((B, W), -1, dtype=torch.int32, device=x.device)
    k_c[:, slots] = k[:, T - n_keep:]
    v_c[:, slots] = v[:, T - n_keep:]
    pos_c[:, slots] = positions[:, T - n_keep:].to(torch.int32)
    return delta, {"k": k_c, "v": v_c, "pos": pos_c}


def apply_layer_seq(kind: str, p: dict, cfg: ModelConfig, x, positions, *,
                    capacity_mode: str, max_seq: int):
    """One layer over a full sequence.  Returns (x, cache entry)."""
    window = cfg.window if kind == "local" else 0
    delta, cache = _self_attn_sublayer(p, x, cfg, positions, window=window,
                                       cache_len=cache_len(cfg, kind, max_seq))
    x = x + delta
    x = x + _ffn_sublayer(p, x, cfg, capacity_mode)
    return x, cache


def embed_tokens(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def lm_head(params, cfg: ModelConfig, x):
    h = rms_norm(x, params["final_norm"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ w.to(h.dtype)
    return softcap(logits, cfg.logit_softcap) if cfg.logit_softcap else logits


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int, capacity_mode: str = "auto"):
    """Prefill pass building the decode cache.  tokens: (B, T).

    capacity_mode "auto": drop-free ("full") for B*T <= 2048, bounded
    "eval" capacity above.  Returns (last-token logits (B, V), cache)."""
    _check_kinds(cfg)
    B, T = tokens.shape
    if capacity_mode == "auto":
        capacity_mode = "full" if B * T <= 2048 else "eval"
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    cache = []
    for kind, lp in zip(cfg.layer_kinds, params["layers"]):
        x, c = apply_layer_seq(kind, lp, cfg, x, positions,
                               capacity_mode=capacity_mode, max_seq=max_seq)
        cache.append(c)
    return lm_head(params, cfg, x[:, -1]), cache


# ---------------------------------------------------------------------------
# decode mode (single token)
# ---------------------------------------------------------------------------


def self_attn_decode_sublayer(p: dict, cfg: ModelConfig, x, pos, cache: dict,
                              window: int):
    """Decode-mode self-attention sublayer, shared with the disaggregated
    runtime.  x: (B, d), pos: (B,) int32.  Writes this token's K/V into
    the ring slot ``pos % W`` of ``cache`` in place; the attention read
    goes through ``kernels.decode_attention``.  Returns delta."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    h = rms_norm(x, p["ln1"])
    q = (h @ p["wq"]).reshape(B, H, hd)
    k = (h @ p["wk"]).reshape(B, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, Hkv, hd)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    W = cache["k"].shape[1]
    b_idx = torch.arange(B, device=x.device)
    slot = (pos % W).long()
    cache["k"][b_idx, slot] = k.to(cache["k"].dtype)
    cache["v"][b_idx, slot] = v.to(cache["v"].dtype)
    cache["pos"][b_idx, slot] = pos.to(torch.int32)
    out = kops.decode_attention(q, cache["k"], cache["v"], cache["pos"], pos,
                                window=window, attn_softcap=cfg.attn_softcap)
    delta = out.reshape(B, H * hd) @ p["wo"]
    return _maybe_post(p, "ln1_post", delta, cfg)


def ffn_decode_sublayer(p: dict, cfg: ModelConfig, x, capacity_mode: str):
    h = rms_norm(x, p["ln2"])
    if cfg.moe is not None:
        y = moe_ffn(p, h, cfg.moe, cfg.act, capacity_mode)
    else:
        y = gated_ffn(h, p["w1"], p["w3"], p["w2"], cfg.act)
    return _maybe_post(p, "ln2_post", y, cfg)


def apply_layer_decode(kind: str, p: dict, cfg: ModelConfig, x, pos,
                       cache: dict, capacity_mode: str):
    window = cfg.window if kind == "local" else 0
    x = x + self_attn_decode_sublayer(p, cfg, x, pos, cache, window)
    return x + ffn_decode_sublayer(p, cfg, x, capacity_mode)


def decode_step(params: dict, cfg: ModelConfig, tokens, cache: List[dict],
                pos, capacity_mode: str = "full"):
    """One decode step.  tokens: (B,) int, pos: (B,) int32.  Updates
    ``cache`` in place and returns (logits (B, V), cache)."""
    x = embed_tokens(params, cfg, tokens)
    for kind, lp, lc in zip(cfg.layer_kinds, params["layers"], cache):
        x = apply_layer_decode(kind, lp, cfg, x, pos, lc, capacity_mode)
    return lm_head(params, cfg, x), cache
