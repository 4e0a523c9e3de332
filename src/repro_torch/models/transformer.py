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

import contextlib
import functools
from typing import List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import parallel
from repro_torch.models.common import (activation, apply_rope, dense_init,
                                       rms_norm, softcap)
from repro_torch.models.ffn import gated_ffn
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rglru import rglru_block, rglru_block_step
from repro_torch.models.ssd import ssd_block, ssd_block_step
from repro_torch.trace import span

# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _maker(gen, dtype, device, keep):
    """(init, zeros): a named leaf drawn (``dense_init``) or made zero,
    handed to ``keep(name, tensor)`` as soon as it exists."""
    init = lambda name, shape, dt=dtype, **kw: keep(
        name, dense_init(gen, shape, dt, device, **kw))
    zeros = lambda name, n, dt=dtype: keep(
        name, torch.zeros(n, dtype=dt, device=device))
    return init, zeros


def _init_ffn(gen, cfg: ModelConfig, dtype, device, keep) -> dict:
    d = cfg.d_model
    init, _ = _maker(gen, dtype, device, keep)
    if cfg.moe is not None:
        m = cfg.moe
        p = {
            "router": init("router", (d, m.n_experts), torch.float32),  # stays f32
            "we1": init("we1", (m.n_experts, d, m.d_ff_expert)),
            "we3": init("we3", (m.n_experts, d, m.d_ff_expert)),
            "we2": init("we2", (m.n_experts, m.d_ff_expert, d)),
        }
        if m.n_shared_experts:
            p.update({"ws1": init("ws1", (d, m.d_ff_shared)),
                      "ws3": init("ws3", (d, m.d_ff_shared)),
                      "ws2": init("ws2", (m.d_ff_shared, d)),
                      "shared_gate": init("shared_gate", (d,), torch.float32,
                                          scale=0.02)})
        if m.d_ff_dense_residual:
            p.update({"wd1": init("wd1", (d, m.d_ff_dense_residual)),
                      "wd3": init("wd3", (d, m.d_ff_dense_residual)),
                      "wd2": init("wd2", (m.d_ff_dense_residual, d))})
        return p
    return {"w1": init("w1", (d, cfg.d_ff)), "w3": init("w3", (d, cfg.d_ff)),
            "w2": init("w2", (cfg.d_ff, d))}


def _init_attn_proj(gen, cfg: ModelConfig, dtype, device, keep, prefix="") -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    init, _ = _maker(gen, dtype, device, keep)
    names = ("wq", "wk", "wv", "wo")
    shapes = ((d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
              (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d))
    return {prefix + n: init(prefix + n, shape) for n, shape in zip(names, shapes)}


def init_layer_params(gen, kind: str, cfg: ModelConfig, dtype, device,
                      keep=None) -> dict:
    """One layer of ``kind``: the JAX package's leaves, shapes and dtypes
    (norms zero, gates zero, the RG-LRU gate matrices and the SSD head
    parameters in f32), drawn from ``gen``.  ``keep(name, tensor)``: what
    the layer keeps of each leaf as soon as it is made (``init_params``'
    ``place``)."""
    keep = keep or (lambda name, t: t)
    d = cfg.d_model
    init, zeros = _maker(gen, dtype, device, keep)
    if kind == "ssd":
        p = {"ln1": zeros("ln1", d)}
    else:
        p = {"ln1": zeros("ln1", d), "ln2": zeros("ln2", d)}
        if cfg.use_post_norm:
            p["ln1_post"] = zeros("ln1_post", d)
            p["ln2_post"] = zeros("ln2_post", d)
    if kind in ("attn", "local"):
        p.update(_init_attn_proj(gen, cfg, dtype, device, keep))
        p.update(_init_ffn(gen, cfg, dtype, device, keep))
    elif kind == "cross":          # llama-3.2-vision gated cross-attention
        p.update(_init_attn_proj(gen, cfg, dtype, device, keep))
        p.update(_init_ffn(gen, cfg, dtype, device, keep))
        p["ln_kv"] = zeros("ln_kv", d)
        p["gate_attn"] = zeros("gate_attn", (), torch.float32)
        p["gate_ffn"] = zeros("gate_ffn", (), torch.float32)
    elif kind == "selfcross":      # whisper decoder layer
        p.update(_init_attn_proj(gen, cfg, dtype, device, keep))
        p.update(_init_attn_proj(gen, cfg, dtype, device, keep, prefix="c_"))
        p.update(_init_ffn(gen, cfg, dtype, device, keep))
        p["ln_cross"] = zeros("ln_cross", d)
    elif kind == "rglru":
        r = cfg.rglru
        w = r.lru_width
        p.update({
            "w_in_x": init("w_in_x", (d, w)),
            "w_in_gate": init("w_in_gate", (d, w)),
            "conv_w": init("conv_w", (r.conv_width, w), scale=0.5),
            "w_a": init("w_a", (w, w), torch.float32),
            "b_a": zeros("b_a", w, torch.float32),
            "w_x": init("w_x", (w, w), torch.float32),
            "b_x": zeros("b_x", w, torch.float32),
            "lam": keep("lam", torch.full((w,), 0.5, dtype=torch.float32,
                                          device=device)),
            "w_out": init("w_out", (w, d)),
        })
        p.update(_init_ffn(gen, cfg, dtype, device, keep))
    elif kind == "ssd":
        s = cfg.ssm
        di, h, n = s.d_inner(d), s.n_heads(d), s.d_state
        lin = lambda a, b: torch.linspace(a, b, h, dtype=torch.float32,
                                          device=device)
        p = {"ln1": p["ln1"],
             "in_proj": init("in_proj", (d, 2 * di + 2 * n + h)),
             "conv_w": init("conv_w", (s.conv_width, di + 2 * n), scale=0.5),
             "dt_bias": keep("dt_bias", torch.log(torch.expm1(lin(1e-3, 0.1)))),
             "A_log": keep("A_log", torch.log(lin(1.0, 16.0))),
             "D": keep("D", torch.ones(h, dtype=torch.float32, device=device)),
             "norm": zeros("norm", di),
             "out_proj": init("out_proj", (di, d))}
    else:
        raise ValueError(kind)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda", place=None) -> dict:
    """Random weights from ``seed`` (truncated-normal fan-in init; norms
    zero, since RMSNorm scales by 1 + scale).  Draws with a
    ``torch.Generator`` on ``device``, so the weights never cross the
    host link.  ``device="meta"`` gives the tree's shapes and dtypes
    only, allocating and drawing nothing.

    ``place(path, tensor)``: what the tree keeps of each leaf (a rank's
    block: ``launch.sharding.Layout.place``), called as soon as the leaf
    is drawn, so only one whole leaf lives at a time; the values are the
    seed's whatever ``place`` keeps."""
    if torch.device(device).type == "meta":
        dev, gen = torch.device("meta"), None
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
    keeper = lambda prefix: ((lambda name, t: place(prefix + name, t)) if place
                             else (lambda name, t: t))
    init, zeros = _maker(gen, dtype, dev, keeper(""))
    d = cfg.d_model
    params = {"embed": init("embed", (cfg.vocab, d), scale=0.02),
              "final_norm": zeros("final_norm", d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init("lm_head", (d, cfg.vocab))
    params["layers"] = [init_layer_params(gen, kind, cfg, dtype, dev,
                                          keeper(f"layers/{i}/"))
                        for i, kind in enumerate(cfg.layer_kinds)]
    if cfg.encoder is not None:
        e_init, e_zeros = _maker(gen, dtype, dev, keeper("encoder/"))
        params["encoder"] = {
            "layers": [init_layer_params(gen, "attn", cfg, dtype, dev,
                                         keeper(f"encoder/layers/{i}/"))
                       for i in range(cfg.encoder.n_layers)],
            "pos_embed": e_init("pos_embed", (cfg.encoder.source_len, d), scale=0.02),
            "final_norm": e_zeros("final_norm", d)}
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
    return rms_norm(y, parallel.seq_weight(p[name])) if cfg.use_post_norm else y


def _normed(x, scale):
    """The sublayer input: ``rms_norm(x, scale)`` of this rank's block of
    the sequence gathered whole inside a sequence-parallel region
    (``parallel.seq_full``), else of x."""
    return parallel.seq_full(rms_norm(x, parallel.seq_weight(scale)))


def _ffn_sublayer(p, x, cfg: ModelConfig, capacity_mode: str,
                  with_aux: bool = False):
    """x: (B, T, d) -> (delta, aux).  aux: the MoE load-balance loss
    with ``with_aux``, else (and for a dense FFN) None."""
    h = _normed(x, p["ln2"])
    B, T, d = h.shape
    aux = None
    if cfg.moe is not None:
        y, aux = moe_ffn(p, h.reshape(B * T, d), cfg.moe, cfg.act,
                         capacity_mode, with_aux=with_aux)
        y = y.reshape(B, -1, d)
    else:
        y = gated_ffn(h, p["w1"], p["w3"], p["w2"], cfg.act, cfg.d_ff)
    return _maybe_post(p, "ln2_post", y, cfg), aux


def _qkv(p, h, cfg: ModelConfig, source=None, prefix: str = ""):
    """(q (B, T, Hq, hd), k, v (B, S, Hkv', hd)): the projections of the
    normed h (and of ``source`` (B, S, d) for K / V where given: a cross
    layer, whose weights carry ``prefix``) for this rank's query heads;
    without a model axis (or where the rules left ``wq`` whole) every
    head.

    Under a model axis ``wq`` holds the rank's block of the H * hd
    columns: the contiguous heads [h0, h0 + Hl) where H splits over the
    axis, else a block that cuts a head, and then the whole weight is
    gathered and enters the rank's region, so q holds every head (the
    rank keeps its columns before ``wo``: ``_out_proj``).  ``wk`` / ``wv``
    hold the matching kv heads where Hkv splits over the axis, and k / v
    are then those Hkv / m heads; where it does not (reduced mixtral and
    granite have one kv head), the rule still splits their columns
    whenever Hkv * hd divides the axis, so the whole weight is gathered
    first and enters the rank's region (its gradient the sum over the
    ranks), as is a weight the rule left whole, and k / v hold every kv
    head (``_rank_kv`` picks the ones the rank's query heads read)."""
    B, T, _ = h.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    src = h if source is None else source
    S = src.shape[1]
    wq, wk, wv = (p[prefix + n] for n in ("wq", "wk", "wv"))
    mp = parallel.current()
    heads = mp.block(H * hd, wq.shape[1]) if mp is not None else None
    if heads is None:
        return ((h @ wq).reshape(B, T, H, hd),
                (src @ wk).reshape(B, S, Hkv, hd),
                (src @ wv).reshape(B, S, Hkv, hd))
    x = mp.enter_seq(h)
    xs = x if source is None else mp.enter(source)
    if H % mp.size:
        wq = mp.enter_gather(wq, 1)
    q = (x @ wq).reshape(B, T, -1, hd)
    kv = []
    for w in (wk, wv):
        if Hkv % mp.size == 0 and w.shape[1] * mp.size == Hkv * hd:
            kv.append((xs @ w).reshape(B, S, Hkv // mp.size, hd))
            continue
        w = mp.enter(w) if w.shape[1] == Hkv * hd else mp.enter_gather(w, 1)
        kv.append((xs @ w).reshape(B, S, Hkv, hd))
    return q, kv[0], kv[1]


def _out_proj(p, out, cfg: ModelConfig, name: str = "wo"):
    """``out`` (..., n_q * hd) through ``p[name]``: under a model axis that
    splits its rows, this rank's block of the flattened head columns (all
    of them are computed where the query heads do not split) times its
    rows, summed over the axis."""
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    wo = p[name]
    mp = parallel.current()
    rows = mp.block(H * hd, wo.shape[0]) if mp is not None else None
    if rows is None:
        return parallel.seq_block(out @ wo)
    if out.shape[-1] != wo.shape[0]:
        out = out[..., rows]
    return mp.reduce_act(out @ wo)


def _every_head(p, h, cfg: ModelConfig, names, prefix: str = ""):
    """Every head of the projections ``names`` (of "wq", "wk", "wv") of the
    normed h (B, d), on every rank, for serving (no autograd): a weight
    the rules split (by heads or mid-head) is applied as the rank's
    columns and the blocks of all of them gathered in one collective; a
    whole weight is applied as it is.  Returns (B, heads, hd) each."""
    B = h.shape[0]
    hd = cfg.resolved_head_dim
    width = {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd,
             "wv": cfg.n_kv_heads * hd}
    mp = parallel.current()
    out, split = {}, []
    for n in names:
        w = p[prefix + n]
        if w.shape[1] == width[n]:
            out[n] = h @ w
        else:
            split.append((n, h @ w))
    if split:
        cols = [y.shape[-1] for _, y in split]
        g = mp.gather(torch.cat([y for _, y in split], dim=-1), -1)
        g = g.reshape(B, mp.size, sum(cols))
        for (n, _), part in zip(split, torch.split(g, cols, dim=-1)):
            out[n] = part.reshape(B, -1)
    return [out[n].reshape(B, -1, hd) for n in names]


def _rank_kv(t, cfg: ModelConfig, n_q: int):
    """K or V for the attention of this rank's ``n_q`` query heads: ``t``
    itself where it holds their kv heads (or every head is the rank's),
    else the kv head each of them reads, one per query head."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    mp = parallel.current()
    if n_q == H or t.shape[2] != Hkv:
        return t
    h0 = mp.index * n_q
    return t[:, :, torch.arange(h0, h0 + n_q, device=t.device) // (H // Hkv)]


def _kv_layout(mp, rows: int, S: int, Hkv: int, hd: int):
    """This rank's block of a (rows, S, Hkv, hd) KV ring or cross source
    under ``sharding.cache_entry_specs``: (its kv heads (a slice, or None
    for every head), its slots (a slice, or None), the axes the slots
    split over (or None))."""
    spec = mp.kv_spec(rows, S, Hkv, hd)
    heads = None
    if spec[2] is not None:
        g = Hkv // mp.mesh.size(spec[2])
        i = mp.mesh.index(spec[2])
        heads = slice(i * g, (i + 1) * g)
    slots = None
    if spec[1] is not None:
        wl = S // mp.mesh.size(spec[1])
        i = mp.mesh.index(spec[1])
        slots = slice(i * wl, (i + 1) * wl)
    return heads, slots, spec[1]


def _slot_axes(mp, rows: int, W: int, Hkv: int, hd: int):
    """The axes ``cache_entry_specs`` splits a ring's slots over where
    they divide (None for none): the rule's choice for a width that every
    axis divides."""
    return mp.kv_spec(rows, W * mp.mesh.size(mp.mesh.axis_names), Hkv, hd)[1]


def _ring_layout(mp, rows: int, W: int, Hkv: int, hd: int):
    """``_kv_layout`` of a (rows, W, Hkv, hd) KV ring.  A ring whose slots
    the rule would split over axes that do not divide them is refused:
    the rank could not tell its block from its shape."""
    want = _slot_axes(mp, rows, W, Hkv, hd)
    if mp.kv_spec(rows, W, Hkv, hd)[1] != want:
        raise NotImplementedError(f"a ring of {W} slots does not split over "
                                  f"the {want} axes")
    return _kv_layout(mp, rows, W, Hkv, hd)


def _self_attn_sublayer(p, x, cfg: ModelConfig, positions, *, causal: bool = True,
                        window: int = 0, build_cache: bool = True,
                        cache_len: int = 0):
    """Returns (delta, cache entry of ring width ``cache_len`` or None).
    ``causal=False`` (the whisper encoder): no RoPE (the encoder adds a
    learned position embedding) and every key attended.  Under a model
    axis the entry is this rank's block of the ring (``_ring_layout``).
    Inside a sequence-parallel region x is this rank's block of the
    sequence, and so is the delta."""
    B, T = positions.shape
    q, k, v = _qkv(p, _normed(x, p["ln1"]), cfg)
    if causal:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    n_q = q.shape[2]
    out = attn_lib.attention(q, _rank_kv(k, cfg, n_q), _rank_kv(v, cfg, n_q),
                             positions, positions, causal=causal,
                             window=window, attn_softcap=cfg.attn_softcap)
    delta = _maybe_post(p, "ln1_post", _out_proj(p, out.reshape(B, T, -1), cfg), cfg)
    if not build_cache:
        return delta, None
    W = cache_len
    slots = None
    mp = parallel.current()
    if mp is not None:       # k / v hold the rank's kv heads where they split
        _, slots, _ = _ring_layout(mp, B, W, cfg.n_kv_heads, k.shape[3])
    Hkv, hd = k.shape[2], k.shape[3]
    n_keep = min(T, W)
    slot_of = (positions[0, T - n_keep:] % W).long()
    k_c = k.new_zeros((B, W, Hkv, hd))
    v_c = v.new_zeros((B, W, Hkv, hd))
    pos_c = torch.full((B, W), -1, dtype=torch.int32, device=x.device)
    k_c[:, slot_of] = k[:, T - n_keep:]
    v_c[:, slot_of] = v[:, T - n_keep:]
    pos_c[:, slot_of] = positions[:, T - n_keep:].to(torch.int32)
    if slots is not None:        # the rank's block of the ring's slots
        k_c, v_c, pos_c = (t[:, slots].clone(memory_format=torch.contiguous_format)
                           for t in (k_c, v_c, pos_c))
    return delta, {"k": k_c, "v": v_c, "pos": pos_c}


def _cross_sublayer(p, x, cfg: ModelConfig, source, ln: str, prefix: str,
                    build_cache: bool):
    """Cross attention of the ``ln``-normed x to the source embeddings (B,
    S, d), ``ln_kv``-normed first where the layer has one (the
    llama-3.2-vision cross layer).  Returns (delta, {"k_src", "v_src"} or
    None): under a model axis the rank's heads (``_qkv``) and its block of
    the source's K / V (``_kv_layout``: its kv heads, its slots or the
    whole source)."""
    src = rms_norm(source, p["ln_kv"]) if "ln_kv" in p else source
    q, k, v = _qkv(p, _normed(x, p[ln]), cfg, source=src, prefix=prefix)
    B, T = q.shape[:2]
    n_q = q.shape[2]
    out = attn_lib.cross_attention(q, _rank_kv(k, cfg, n_q), _rank_kv(v, cfg, n_q))
    delta = _out_proj(p, out.reshape(B, T, -1), cfg, prefix + "wo")
    if not build_cache:
        return delta, None
    mp = parallel.current()
    if mp is not None:
        _, slots, _ = _kv_layout(mp, B, k.shape[1], cfg.n_kv_heads, k.shape[3])
        if slots is not None:
            k, v = (t[:, slots].clone(memory_format=torch.contiguous_format)
                    for t in (k, v))
    return delta, {"k_src": k, "v_src": v}


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
    # a prefill's sublayers are spans (the training passes build no cache)
    part = span if build_cache else (lambda name: contextlib.nullcontext())

    def ffn(p, x):
        with part("model.prefill.ffn"):
            return _ffn_sublayer(p, x, cfg=cfg, capacity_mode=capacity_mode,
                                 with_aux=with_aux)

    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        with part("model.prefill.attn"):
            delta, cache = _self_attn_sublayer(
                p, x, cfg, positions, causal=causal, window=window,
                build_cache=build_cache, cache_len=cache_len(cfg, kind, max_seq))
        x = x + delta
        dff, aux = ffn(p, x)
        x = x + dff
    elif kind == "cross":
        delta, cache = _cross_sublayer(p, x, cfg, source, "ln1", "", build_cache)
        x = x + _gated(parallel.seq_weight(p["gate_attn"]), delta, x.dtype)
        dff, aux = ffn(p, x)
        x = x + _gated(parallel.seq_weight(p["gate_ffn"]), dff, x.dtype)
    elif kind == "selfcross":
        with part("model.prefill.attn"):
            delta, cache = _self_attn_sublayer(
                p, x, cfg, positions, build_cache=build_cache, cache_len=max_seq)
        x = x + delta
        delta, src_cache = _cross_sublayer(p, x, cfg, source, "ln_cross", "c_",
                                           build_cache)
        x = x + delta
        dff, aux = ffn(p, x)
        x = x + dff
        if build_cache:
            cache = dict(cache, **src_cache)
    elif kind == "rglru":
        y, state = rglru_block(p, _normed(x, p["ln1"]), cfg.rglru, _gelu, None)
        x = x + y
        dff, aux = ffn(p, x)
        x = x + dff
        cache = state if build_cache else None
    elif kind == "ssd":
        y, state = ssd_block(p, _normed(x, p["ln1"]), cfg.ssm, cfg.d_model, None)
        x = x + y
        cache = state if build_cache else None
    else:
        raise ValueError(kind)
    return x, cache, aux


def vocab_block(params, cfg: ModelConfig):
    """(the installed model axis, this rank's slice of the vocabulary) where
    the embedding's rows are split over it, else (None, None)."""
    mp = parallel.current()
    rows = mp.block(cfg.vocab, params["embed"].shape[0]) if mp is not None else None
    return (mp, rows) if rows is not None else (None, None)


def embed_tokens(params, cfg: ModelConfig, tokens):
    """Under a model axis that splits the vocabulary each rank looks up
    the ids of its rows (0 for the others) and the lookups are summed."""
    mp, rows = vocab_block(params, cfg)
    if mp is None:
        x = params["embed"][tokens.long()]
    else:
        ids = tokens.long() - rows.start
        mine = (ids >= 0) & (ids < rows.stop - rows.start)
        x = params["embed"][torch.where(mine, ids, 0)]
        x = mp.reduce(x * mine[..., None].to(x.dtype))
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """The LM head's (d, V) weight (this rank's vocabulary columns under a
    model axis that splits it)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_head(params, cfg: ModelConfig, x):
    """Logits over the whole vocabulary; under a model axis that splits
    it, each rank's columns gathered."""
    h = rms_norm(x, params["final_norm"])
    w = head_weight(params, cfg)
    mp, _ = vocab_block(params, cfg)
    if mp is None:
        logits = h @ w.to(h.dtype)
    else:
        logits = mp.gather(mp.enter(h) @ w.to(h.dtype), -1)
    return softcap(logits, cfg.logit_softcap) if cfg.logit_softcap else logits


def _encode(params: dict, cfg: ModelConfig, frames) -> torch.Tensor:
    """Whisper-style encoder over stubbed frame embeddings (B, S, d): a
    learned position embedding, non-causal ``attn`` layers, a final
    norm.  Under a model axis its layers are tensor-parallel as the
    decoder's (the whole ``pos_embed`` on every rank)."""
    enc = parallel.use_params(params["encoder"], "encoder")
    x = frames.to(enc["pos_embed"].dtype) + enc["pos_embed"][None]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i, lp in enumerate(enc["layers"]):
        lp = parallel.use_params(lp, f"encoder/layers/{i}")
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
    remainder layers outside it, as in JAX.

    Under a sequence-parallel model axis (``parallel.ModelParallel(...,
    seq_parallel=True)``) the block periods hold this rank's block of
    the sequence between their layers, where JAX's ``ACT_SPEC``
    constrains them; x is whole before and after them.  Each layer's
    params pass ``parallel.use_params`` inside its period's remat, so a
    leaf made whole at its use is made whole again in the recompute."""
    kinds, layers = cfg.layer_kinds, params["layers"]
    mp = parallel.current()
    rows, T = positions.shape
    sp = mp is not None and mp.seq_parallel

    def run(lo, hi, x, aux, periodic=False):
        caches = []
        with (mp.seq_region(rows, T) if sp and periodic else contextlib.nullcontext()):
            for i in range(lo, hi):
                lp = parallel.use_params(layers[i], f"layers/{i}")
                # the prefill's layers (the training passes build no cache)
                with (span("model.prefill.layer") if build_cache
                      else contextlib.nullcontext()):
                    x, c, a = apply_layer_seq(
                        kinds[i], lp, cfg, x, positions, source=source,
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
    sp = sp and n_periodic > 0
    if sp:
        with mp.seq_region(rows, T):
            x = mp.seq_block(x)
    for lo in range(0, n_periodic, period):
        x, aux, c = _remat(remat, run, lo, lo + period, x, aux, True)
        cache += c
    if sp:
        with mp.seq_region(rows, T):
            x = mp.seq_full(x)
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


def _check_model_axis(cfg: ModelConfig):
    """Under a model axis of more than one rank, refuse the layer kinds
    that have none (``parallel.check_kinds``)."""
    mp = parallel.current()
    if mp is not None and mp.size > 1:
        parallel.check_kinds(cfg.layer_kinds)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int, cross_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, capacity_mode: str = "auto"):
    """Prefill pass building the decode cache.  tokens: (B, T).

    capacity_mode "auto": drop-free ("full") for B*T <= 2048, bounded
    "eval" capacity above.  Returns (last-token logits (B, V), cache)."""
    with span("model.prefill"):
        B, T = tokens.shape
        _check_model_axis(cfg)
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
    goes through ``kernels.decode_attention``.  Returns delta.  Under a
    model axis ``cache`` is the rank's block of the ring
    (``_decode_on_shards``)."""
    if parallel.current() is not None:
        return _decode_on_shards(p, cfg, x, pos, cache, window)
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


def _decode_on_shards(p: dict, cfg: ModelConfig, x, pos, cache: dict, window: int):
    """The decode self-attention sublayer on this rank's shards: its block
    of the ring (``_ring_layout``), ``wo``'s rows of its block of the head
    columns (``_out_proj``), then a sum over "model".

    * kv heads over "model": the rank's query heads (``_qkv``) read
      exactly its kv heads, so it writes its heads' K / V into its ring
      and attends there.
    * every kv head on the rank's block of slots: every rank makes every
      head's q, k and v (``_every_head``: its columns of the split
      weights, one gather for all of them: B * (H + 2 Hkv) * hd values,
      where gathering the weights would move d times that per row), only
      the rank that holds slot ``pos % W`` of a row writes it, every rank
      attends with all H heads over its slots (``decode_attention``'s
      partial branch), ``merge_partials`` combines the ranks, and each
      keeps its own block of the head columns for ``wo``.
    A ring whose slots are also split over the data axes (a batch they do
    not divide) merges over those axes too."""
    mp = parallel.current()
    B = x.shape[0]
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    h = rms_norm(x, p["ln1"])
    Wl = cache["k"].shape[1]
    # the axes the rule splits the slots over, hence the ring's width
    n_w = mp.mesh.size(_slot_axes(mp, B, Wl, Hkv, hd) or ())
    heads, slots, w_axes = _ring_layout(mp, B, Wl * n_w, Hkv, hd)
    if heads is not None:
        q, k, v = (t[:, 0] for t in _qkv(p, h[:, None], cfg))
    else:
        q, k, v = _every_head(p, h, cfg, ("wq", "wk", "wv"))
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    block = (B, Wl, k.shape[1], hd)     # k / v: the rank's kv heads, or all
    if tuple(cache["k"].shape) != block:
        raise ValueError(f"a cache block of {tuple(cache['k'].shape)} where the "
                         f"rank holds {block}")
    W = Wl * n_w
    b_idx = torch.arange(B, device=x.device)
    local = (pos % W).long() - (slots.start if slots is not None else 0)
    mine = (local >= 0) & (local < Wl)
    local = torch.where(mine, local, 0)
    for key, new in (("k", k), ("v", v), ("pos", pos)):
        t = cache[key]
        new = new.to(t.dtype)
        keep = mine.reshape((B,) + (1,) * (new.dim() - 1))
        t[b_idx, local] = torch.where(keep, new, t[b_idx, local])
    if slots is None:
        out = kops.decode_attention(q, cache["k"], cache["v"], cache["pos"], pos,
                                    window=window, attn_softcap=cfg.attn_softcap)
    else:
        part, lse = kops.decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                          pos, window=window,
                                          attn_softcap=cfg.attn_softcap,
                                          partial=True)
        out = mp.merge_partials(part, lse, w_axes).to(q.dtype)
    delta = _out_proj(p, out.reshape(B, -1), cfg)
    return _maybe_post(p, "ln1_post", delta, cfg)


def ffn_decode_sublayer(p: dict, cfg: ModelConfig, x, capacity_mode: str):
    h = rms_norm(x, p["ln2"])
    if cfg.moe is not None:
        y, _ = moe_ffn(p, h, cfg.moe, cfg.act, capacity_mode)
    else:
        y = gated_ffn(h, p["w1"], p["w3"], p["w2"], cfg.act, cfg.d_ff)
    return _maybe_post(p, "ln2_post", y, cfg)


def _cross_decode(p: dict, cfg: ModelConfig, kind: str, x, cache: dict, ln: str,
                  prefix: str):
    """Single-token cross attention over the cached source K/V.  Under a
    model axis ``cache`` holds the rank's block of them (``_kv_layout``):
    with its kv heads the rank attends with its query heads; with every
    kv head on the rank's block of the source's slots every rank attends
    with every head over its slots (``_every_head``: one gather of q) and
    the rows are merged (``merge_partials``); with the whole source the
    rank attends with its heads where they split, else with every head.
    The rank then keeps its block of the head columns for ``wo``."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    h = rms_norm(x, p[ln])
    mp = parallel.current()
    if mp is None:
        q = (h @ p[prefix + "wq"]).reshape(B, 1, H, hd)
        out = attn_lib.cross_attention(q, cache["k_src"], cache["v_src"])
        return out.reshape(B, H * hd) @ p[prefix + "wo"]
    heads, slots, axes = _kv_layout(mp, B, _source_len(cfg, kind), cfg.n_kv_heads, hd)
    if heads is None and (slots is not None or H % mp.size):
        q = _every_head(p, h, cfg, ("wq",), prefix)[0]
    else:
        q = (h @ p[prefix + "wq"]).reshape(B, -1, hd)
    q = q[:, None]
    if slots is None:
        n_q = q.shape[2]
        out = attn_lib.cross_attention(q, _rank_kv(cache["k_src"], cfg, n_q),
                                       _rank_kv(cache["v_src"], cfg, n_q))
    else:
        part, lse = attn_lib.cross_attention_partial(q, cache["k_src"], cache["v_src"])
        out = mp.merge_partials(part, lse, axes).to(q.dtype)
    return _out_proj(p, out.reshape(B, -1), cfg, prefix + "wo")


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
        x = x + _gated(p["gate_attn"], _cross_decode(p, cfg, kind, x, cache, "ln1", ""),
                       x.dtype)
        x = x + _gated(p["gate_ffn"], ffn_decode_sublayer(p, cfg, x, capacity_mode),
                       x.dtype)
    elif kind == "selfcross":
        x = x + self_attn_decode_sublayer(p, cfg, x, pos, cache, 0)
        x = x + _cross_decode(p, cfg, kind, x, cache, "ln_cross", "c_")
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
    _check_model_axis(cfg)
    x = embed_tokens(params, cfg, tokens)
    for kind, lp, lc in zip(cfg.layer_kinds, params["layers"], cache):
        x = apply_layer_decode(kind, lp, cfg, x, pos, lc, capacity_mode)
    return lm_head(params, cfg, x), cache
