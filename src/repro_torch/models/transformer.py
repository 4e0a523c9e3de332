"""Transformer assembly for every layer kind of ``config.LAYER_KINDS``.

Parameters are a dict ``{"embed", "final_norm", ["lm_head"], "layers",
["encoder"]}`` where ``layers`` is a list of per-layer dicts in
execution order (the JAX package stacks repeated blocks and scans them;
here a Python loop walks the list) and ``encoder`` (whisper) is
``{"layers", "pos_embed", "final_norm"}``.  The decode cache is a list
of per-layer dicts, by kind:
  attn / local  {"k": (B, W, Hkv, hd), "v": ..., "pos": (B, W) int32}
  cross         {"k_src": (B, S, Hkv, hd), "v_src": ...}
  selfcross     the attn entry plus "k_src" / "v_src"
  rglru         {"h": (B, lru_width) f32, "conv": (B, K-1, lru_width)}
  ssd           {"ssm": (B, h, p, n) f32, "conv": (B, K-1, di + 2n)}
The recurrent states ``h`` and ``ssm`` are f32 whatever the model's
dtype, as in the JAX package.

Public entry points:
  init_params(cfg, seed, dtype, device)               -> params
  init_cache(cfg, batch, max_seq, dtype, device)      -> cache
  prefill(params, cfg, tokens, max_seq, cross_embeds, frames)
                                                      -> (last_logits, cache)
  decode_step(params, cfg, tokens, cache, pos)        -> (logits, cache)
  forward_hidden(params, cfg, tokens, cross_embeds, frames, remat)
                                                      -> (hidden, aux)
  forward_train(params, cfg, tokens, cross_embeds, frames, remat)
                                                      -> (logits, aux)

``aux`` is the sum over the MoE layers of their load-balance losses
(0 for a model without experts).  Only the full-sequence training
passes compute it; ``prefill`` and ``decode_step`` issue none of its
ops.  ``remat`` ("none" | "full" | "dots") is what the JAX package's
scan body is checkpointed with: one block period at a time, under
``torch.utils.checkpoint``; it changes memory, never values.

``decode_step`` writes the new K/V token and the new recurrent states
into the cache in place (the JAX package rebuilt the cache
functionally); callers that slice a cache along the batch axis get
views, so per-micro-batch writes land in the full cache with no merge.
The cross K/V (``k_src`` / ``v_src``) are written once at prefill and
only read by decode.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (activation, apply_rope, dense_init,
                                       rms_norm, softcap)
from repro_torch.models.ffn import gated_ffn
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rglru import rglru_block, rglru_block_step
from repro_torch.models.ssd import ssd_block, ssd_block_step

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


def _init_attn_proj(gen, cfg: ModelConfig, dtype, device, prefix="") -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    init = lambda shape: dense_init(gen, shape, dtype, device)
    return {prefix + "wq": init((d, cfg.n_heads * hd)),
            prefix + "wk": init((d, cfg.n_kv_heads * hd)),
            prefix + "wv": init((d, cfg.n_kv_heads * hd)),
            prefix + "wo": init((cfg.n_heads * hd, d))}


def init_layer_params(gen, kind: str, cfg: ModelConfig, dtype, device) -> dict:
    """One layer of ``kind``: the JAX package's leaves, shapes and dtypes
    (norms zero, gates zero, the RG-LRU gate matrices and the SSD head
    parameters in f32), drawn from ``gen``."""
    d = cfg.d_model
    init = lambda shape, dt=dtype, **kw: dense_init(gen, shape, dt, device, **kw)
    zeros = lambda n, dt=dtype: torch.zeros(n, dtype=dt, device=device)
    p = {"ln1": zeros(d), "ln2": zeros(d)}
    if cfg.use_post_norm:
        p["ln1_post"] = zeros(d)
        p["ln2_post"] = zeros(d)
    if kind in ("attn", "local"):
        p.update(_init_attn_proj(gen, cfg, dtype, device))
        p.update(_init_ffn(gen, cfg, dtype, device))
    elif kind == "cross":          # llama-3.2-vision gated cross-attention
        p.update(_init_attn_proj(gen, cfg, dtype, device))
        p.update(_init_ffn(gen, cfg, dtype, device))
        p["ln_kv"] = zeros(d)
        p["gate_attn"] = zeros((), torch.float32)
        p["gate_ffn"] = zeros((), torch.float32)
    elif kind == "selfcross":      # whisper decoder layer
        p.update(_init_attn_proj(gen, cfg, dtype, device))
        p.update(_init_attn_proj(gen, cfg, dtype, device, prefix="c_"))
        p.update(_init_ffn(gen, cfg, dtype, device))
        p["ln_cross"] = zeros(d)
    elif kind == "rglru":
        r = cfg.rglru
        w = r.lru_width
        p.update({
            "w_in_x": init((d, w)),
            "w_in_gate": init((d, w)),
            "conv_w": init((r.conv_width, w), scale=0.5),
            "w_a": init((w, w), torch.float32),
            "b_a": zeros(w, torch.float32),
            "w_x": init((w, w), torch.float32),
            "b_x": zeros(w, torch.float32),
            "lam": torch.full((w,), 0.5, dtype=torch.float32, device=device),
            "w_out": init((w, d)),
        })
        p.update(_init_ffn(gen, cfg, dtype, device))
    elif kind == "ssd":
        s = cfg.ssm
        di, h, n = s.d_inner(d), s.n_heads(d), s.d_state
        lin = lambda a, b: torch.linspace(a, b, h, dtype=torch.float32,
                                          device=device)
        p = {"ln1": zeros(d),
             "in_proj": init((d, 2 * di + 2 * n + h)),
             "conv_w": init((s.conv_width, di + 2 * n), scale=0.5),
             "dt_bias": torch.log(torch.expm1(lin(1e-3, 0.1))),
             "A_log": torch.log(lin(1.0, 16.0)),
             "D": torch.ones(h, dtype=torch.float32, device=device),
             "norm": zeros(di),
             "out_proj": init((di, d))}
    else:
        raise ValueError(kind)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Random weights from ``seed`` (truncated-normal fan-in init; norms
    zero, since RMSNorm scales by 1 + scale).  Draws with a
    ``torch.Generator`` on ``device``, so the weights never cross the
    host link."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    params = {"embed": dense_init(gen, (cfg.vocab, d), dtype, dev, scale=0.02),
              "final_norm": torch.zeros(d, dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab), dtype, dev)
    params["layers"] = [init_layer_params(gen, kind, cfg, dtype, dev)
                        for kind in cfg.layer_kinds]
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [init_layer_params(gen, "attn", cfg, dtype, dev)
                       for _ in range(cfg.encoder.n_layers)],
            "pos_embed": dense_init(gen, (cfg.encoder.source_len, d), dtype, dev,
                                    scale=0.02),
            "final_norm": torch.zeros(d, dtype=dtype, device=dev)}
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    return min(cfg.window, max_seq) if kind == "local" else max_seq


def _source_len(cfg: ModelConfig, kind: str) -> int:
    """Source slots of a cross / selfcross layer's ``k_src`` / ``v_src``."""
    enc = cfg.encoder.source_len if cfg.encoder else 0
    if kind == "cross":
        return cfg.cross_source_len or enc
    return enc or cfg.cross_source_len


def init_cache_entry(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device) -> dict:
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)

    def kv(W):
        return {"k": zeros(batch, W, Hkv, hd), "v": zeros(batch, W, Hkv, hd),
                "pos": torch.full((batch, W), -1, dtype=torch.int32,
                                  device=device)}

    def src():
        S = _source_len(cfg, kind)
        return {"k_src": zeros(batch, S, Hkv, hd),
                "v_src": zeros(batch, S, Hkv, hd)}

    if kind in ("attn", "local"):
        return kv(cache_len(cfg, kind, max_seq))
    if kind == "cross":
        return src()
    if kind == "selfcross":
        return dict(kv(max_seq), **src())
    if kind == "rglru":
        r = cfg.rglru
        return {"h": zeros(batch, r.lru_width, dt=torch.float32),
                "conv": zeros(batch, r.conv_width - 1, r.lru_width)}
    if kind == "ssd":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        return {"ssm": zeros(batch, s.n_heads(cfg.d_model), s.head_dim,
                             s.d_state, dt=torch.float32),
                "conv": zeros(batch, s.conv_width - 1, di + 2 * s.d_state)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda") -> List[dict]:
    dev = resolve_device(device)
    return [init_cache_entry(kind, cfg, batch, max_seq, dtype, dev)
            for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# sequence mode (prefill, full-sequence pass)
# ---------------------------------------------------------------------------


def _maybe_post(p, name, y, cfg):
    return rms_norm(y, p[name]) if cfg.use_post_norm else y


def _ffn_sublayer(p, x, cfg: ModelConfig, capacity_mode: str,
                  with_aux: bool = False):
    """x: (B, T, d) -> (delta, aux).  aux: the MoE load-balance loss
    with ``with_aux``, else (and for a dense FFN) None."""
    B, T, d = x.shape
    h = rms_norm(x, p["ln2"])
    aux = None
    if cfg.moe is not None:
        y, aux = moe_ffn(p, h.reshape(B * T, d), cfg.moe, cfg.act,
                         capacity_mode, with_aux=with_aux)
        y = y.reshape(B, T, d)
    else:
        y = gated_ffn(h, p["w1"], p["w3"], p["w2"], cfg.act)
    return _maybe_post(p, "ln2_post", y, cfg), aux


def _self_attn_sublayer(p, x, cfg: ModelConfig, positions, *, causal: bool = True,
                        window: int = 0, build_cache: bool = True,
                        cache_len: int = 0):
    """Returns (delta, cache entry of ring width ``cache_len`` or None).
    ``causal=False`` (the whisper encoder): no RoPE (the encoder adds a
    learned position embedding) and every key attended."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    h = rms_norm(x, p["ln1"])
    q = (h @ p["wq"]).reshape(B, T, H, hd)
    k = (h @ p["wk"]).reshape(B, T, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, T, Hkv, hd)
    if causal:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attn_lib.attention(q, k, v, positions, positions, causal=causal,
                             window=window, attn_softcap=cfg.attn_softcap)
    delta = _maybe_post(p, "ln1_post", out.reshape(B, T, H * hd) @ p["wo"], cfg)
    if not build_cache:
        return delta, None
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


def _cross_kv(p, cfg: ModelConfig, source, prefix=""):
    """K / V of the source embeddings (B, S, d): ``ln_kv``-normed first
    where the layer has one (the llama-3.2-vision cross layer)."""
    B, S, _ = source.shape
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    src = rms_norm(source, p["ln_kv"]) if "ln_kv" in p else source
    k = (src @ p[prefix + "wk"]).reshape(B, S, Hkv, hd)
    v = (src @ p[prefix + "wv"]).reshape(B, S, Hkv, hd)
    return k, v


def _gated(gate, y, dtype):
    """tanh(gate) * y in f32 (the gate is an f32 scalar), cast to dtype."""
    return (torch.tanh(gate) * y.float()).to(dtype)


def _gelu(t):
    return activation(t, "gelu")


def apply_layer_seq(kind: str, p: dict, cfg: ModelConfig, x, positions, *,
                    source=None, capacity_mode: str, max_seq: int,
                    causal: bool = True, build_cache: bool = True,
                    with_aux: bool = False):
    """One layer over a full sequence.  Returns (x, cache entry or None,
    aux: an MoE layer's load-balance loss with ``with_aux``, else None)."""
    cache, aux = None, None
    ffn = functools.partial(_ffn_sublayer, cfg=cfg, capacity_mode=capacity_mode,
                            with_aux=with_aux)
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        delta, cache = _self_attn_sublayer(
            p, x, cfg, positions, causal=causal, window=window,
            build_cache=build_cache, cache_len=cache_len(cfg, kind, max_seq))
        x = x + delta
        dff, aux = ffn(p, x)
        x = x + dff
    elif kind == "cross":
        B, T, _ = x.shape
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        q = (rms_norm(x, p["ln1"]) @ p["wq"]).reshape(B, T, H, hd)
        k, v = _cross_kv(p, cfg, source)
        out = attn_lib.cross_attention(q, k, v).reshape(B, T, H * hd)
        x = x + _gated(p["gate_attn"], out @ p["wo"], x.dtype)
        dff, aux = ffn(p, x)
        x = x + _gated(p["gate_ffn"], dff, x.dtype)
        if build_cache:
            cache = {"k_src": k, "v_src": v}
    elif kind == "selfcross":
        delta, cache = _self_attn_sublayer(
            p, x, cfg, positions, build_cache=build_cache, cache_len=max_seq)
        x = x + delta
        B, T, _ = x.shape
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        q = (rms_norm(x, p["ln_cross"]) @ p["c_wq"]).reshape(B, T, H, hd)
        k, v = _cross_kv(p, cfg, source, prefix="c_")
        out = attn_lib.cross_attention(q, k, v).reshape(B, T, H * hd)
        x = x + out @ p["c_wo"]
        dff, aux = ffn(p, x)
        x = x + dff
        if build_cache:
            cache = dict(cache, k_src=k, v_src=v)
    elif kind == "rglru":
        y, state = rglru_block(p, rms_norm(x, p["ln1"]), cfg.rglru, _gelu, None)
        x = x + y
        dff, aux = ffn(p, x)
        x = x + dff
        cache = state if build_cache else None
    elif kind == "ssd":
        y, state = ssd_block(p, rms_norm(x, p["ln1"]), cfg.ssm, cfg.d_model, None)
        x = x + y
        cache = state if build_cache else None
    else:
        raise ValueError(kind)
    return x, cache, aux


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


def _encode(params: dict, cfg: ModelConfig, frames) -> torch.Tensor:
    """Whisper-style encoder over stubbed frame embeddings (B, S, d): a
    learned position embedding, non-causal ``attn`` layers, a final
    norm."""
    enc = params["encoder"]
    x = frames.to(enc["pos_embed"].dtype) + enc["pos_embed"][None]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp in enc["layers"]:
        x, _, _ = apply_layer_seq("attn", lp, cfg, x, positions,
                                  capacity_mode="full", max_seq=S, causal=False,
                                  build_cache=False)
    return rms_norm(x, enc["final_norm"])


def _source(params, cfg: ModelConfig, cross_embeds, frames):
    """The cross layers' source: the encoder's output over ``frames``
    (whisper) or the stub ``cross_embeds`` (vision), in the weights'
    dtype."""
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name} needs encoder frames")
        return _encode(params, cfg, frames)
    if cfg.has_cross:
        if cross_embeds is None:
            raise ValueError(f"{cfg.name} needs cross_embeds")
        return cross_embeds.to(params["embed"].dtype)
    return None


REMAT = ("none", "full", "dots")

# "dots" keeps the outputs of dot products without batch dimensions (a
# 2-D ``mm``; ``x @ w`` over (B, T, d) folds into one), as JAX's
# ``checkpoint_dots_with_no_batch_dims``, and recomputes everything
# else: the expert einsums (``bmm``, batched by expert) and attention
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(remat: str, fn, *args):
    """fn(*args), with what backward needs kept per ``remat``: "none"
    everything, "full" nothing (recomputed in backward, JAX's
    ``nothing_saveable``), "dots" the no-batch dot outputs."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")


def _seq_pass(params, cfg: ModelConfig, x, positions, source, capacity_mode,
              build_cache: bool, max_seq: int, remat: str = "none",
              with_aux: bool = False):
    """The layer stack over a sequence.  Returns (x, aux, cache): aux
    summed in the JAX package's order (block periods, then the
    remainder) with ``with_aux``, else None; cache None without
    ``build_cache``.  Each block period runs under ``_remat``; the
    remainder layers outside it, as in JAX."""
    kinds, layers = cfg.layer_kinds, params["layers"]

    def run(lo, hi, x, aux):
        caches = []
        for kind, lp in zip(kinds[lo:hi], layers[lo:hi]):
            x, c, a = apply_layer_seq(kind, lp, cfg, x, positions, source=source,
                                      capacity_mode=capacity_mode, max_seq=max_seq,
                                      build_cache=build_cache, with_aux=with_aux)
            if a is not None:
                aux = aux + a
            caches.append(c)
        return x, aux, caches

    aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
    period = len(cfg.block_pattern)
    n_periodic = cfg.n_blocks * period
    cache = []
    for lo in range(0, n_periodic, period):
        x, aux, c = _remat(remat, run, lo, lo + period, x, aux)
        cache += c
    x, aux, c = run(n_periodic, len(kinds), x, aux)
    cache += c
    return x, aux, (cache if build_cache else None)


def forward_hidden(params: dict, cfg: ModelConfig, tokens,
                   cross_embeds: Optional[torch.Tensor] = None,
                   frames: Optional[torch.Tensor] = None, remat: str = "full",
                   capacity_mode: str = "train"):
    """Full-sequence forward up to (but excluding) the LM head, with no
    cache.  Returns (hidden (B, T, d), aux: the summed MoE load-balance
    loss, f32 scalar).  The training loss's chunked cross-entropy reads
    the hidden states, so (B, T, V) logits are never whole."""
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    source = _source(params, cfg, cross_embeds, frames)
    x, aux, _ = _seq_pass(params, cfg, x, positions, source, capacity_mode,
                          build_cache=False, max_seq=T, remat=remat,
                          with_aux=True)
    return x, aux


def forward_train(params: dict, cfg: ModelConfig, tokens,
                  cross_embeds: Optional[torch.Tensor] = None,
                  frames: Optional[torch.Tensor] = None, remat: str = "full",
                  capacity_mode: str = "train"):
    """Full-sequence forward.  tokens: (B, T).  Returns (logits (B, T,
    V), aux)."""
    x, aux = forward_hidden(params, cfg, tokens, cross_embeds, frames, remat,
                            capacity_mode)
    return lm_head(params, cfg, x), aux


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int, cross_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, capacity_mode: str = "auto"):
    """Prefill pass building the decode cache.  tokens: (B, T).

    capacity_mode "auto": drop-free ("full") for B*T <= 2048, bounded
    "eval" capacity above.  Returns (last-token logits (B, V), cache)."""
    B, T = tokens.shape
    if capacity_mode == "auto":
        capacity_mode = "full" if B * T <= 2048 else "eval"
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    source = _source(params, cfg, cross_embeds, frames)
    x, _, cache = _seq_pass(params, cfg, x, positions, source, capacity_mode,
                            build_cache=True, max_seq=max_seq)
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
        y, _ = moe_ffn(p, h, cfg.moe, cfg.act, capacity_mode)
    else:
        y = gated_ffn(h, p["w1"], p["w3"], p["w2"], cfg.act)
    return _maybe_post(p, "ln2_post", y, cfg)


def _cross_decode(p: dict, cfg: ModelConfig, x, cache: dict, ln: str,
                  prefix: str):
    """Single-token cross attention over the cached source K/V."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    q = (rms_norm(x, p[ln]) @ p[prefix + "wq"]).reshape(B, 1, H, hd)
    out = attn_lib.cross_attention(q, cache["k_src"], cache["v_src"])
    return out.reshape(B, H * hd) @ p[prefix + "wo"]


def _write_state(cache: dict, state: dict):
    for key, t in state.items():
        cache[key].copy_(t)


def apply_layer_decode(kind: str, p: dict, cfg: ModelConfig, x, pos,
                       cache: dict, capacity_mode: str):
    """One layer for one token.  x: (B, d), pos: (B,) int32.  Updates
    ``cache`` in place and returns x."""
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        x = x + self_attn_decode_sublayer(p, cfg, x, pos, cache, window)
        x = x + ffn_decode_sublayer(p, cfg, x, capacity_mode)
    elif kind == "cross":
        x = x + _gated(p["gate_attn"], _cross_decode(p, cfg, x, cache, "ln1", ""),
                       x.dtype)
        x = x + _gated(p["gate_ffn"], ffn_decode_sublayer(p, cfg, x, capacity_mode),
                       x.dtype)
    elif kind == "selfcross":
        x = x + self_attn_decode_sublayer(p, cfg, x, pos, cache, 0)
        x = x + _cross_decode(p, cfg, x, cache, "ln_cross", "c_")
        x = x + ffn_decode_sublayer(p, cfg, x, capacity_mode)
    elif kind == "rglru":
        y, state = rglru_block_step(p, rms_norm(x, p["ln1"]), cfg.rglru, _gelu,
                                    cache)
        _write_state(cache, state)
        x = x + y
        x = x + ffn_decode_sublayer(p, cfg, x, capacity_mode)
    elif kind == "ssd":
        y, state = ssd_block_step(p, rms_norm(x, p["ln1"]), cfg.ssm, cfg.d_model,
                                  cache)
        _write_state(cache, state)
        x = x + y
    else:
        raise ValueError(kind)
    return x


def decode_step(params: dict, cfg: ModelConfig, tokens, cache: List[dict],
                pos, capacity_mode: str = "full"):
    """One decode step.  tokens: (B,) int, pos: (B,) int32.  Updates
    ``cache`` in place and returns (logits (B, V), cache)."""
    x = embed_tokens(params, cfg, tokens)
    for kind, lp, lc in zip(cfg.layer_kinds, params["layers"], cache):
        x = apply_layer_decode(kind, lp, cfg, x, pos, lc, capacity_mode)
    return lm_head(params, cfg, x), cache
