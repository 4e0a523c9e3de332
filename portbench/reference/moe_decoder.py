"""Plain float32 reference of a decoder of attention layers with a top-k
mixture-of-experts FFN and an optional dense residual FFN: Mixtral's
layer (hf:mistralai/Mixtral-8x22B-v0.1), and Arctic's (hf:Snowflake/
snowflake-arctic-base) as the configuration file states it is run.

One full causal pass over each sequence, with no cache, no batching
across sequences in attention, and no kernels.  It imports torch alone:
nothing of the program under test.  Its weights come from ``w.leaf(path,
index=None)``: the benchmark's own draw, as float32.

Per layer, with x the residual stream and norm(v, s) = v / rms(v) * (1 + s):
  h = norm(x, ln1);  q, k, v = h Wq, h Wk, h Wv;  RoPE on q, k (split
  halves, theta from the file);  grouped-query causal softmax attention,
  scale head_dim ** -0.5;  x += attn Wo
  h = norm(x, ln2);  p = softmax(h R);  the top-k experts by p (ties to
  the lower index), gates renormalised to sum 1;  y = sum_k g_k *
  (silu(h W1_e) * (h W3_e)) W2_e;  plus silu(h Wd1) * (h Wd3) Wd2 where
  the file gives a dense residual;  x += y
  logits = norm(x, final_norm) Whead

``linear="fp8"`` is the control of the check: every matrix product but
the router's and attention's own takes its input rows and its weight
columns through float8 e4m3 with a scale per row / column (amax / 448),
the precision a later change might serve in, accumulated in float32.
"""
from __future__ import annotations

from typing import Callable, List

import torch

FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t through float8 e4m3 with one scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _matmul(linear: str) -> Callable:
    if linear == "f32":
        return lambda a, w: a @ w
    if linear == "fp8":
        return lambda a, w: _fp8(a, -1) @ _fp8(w, 0)
    raise ValueError(f"linear precision {linear!r}")


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def _rope(x, theta):
    """x: (n, heads, hd) at positions 0..n-1, rotated on split halves."""
    n, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q, k, v, block: int = 256):
    """Causal grouped-query attention. q: (n, H, hd), k / v: (n, Hkv, hd)."""
    n, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)       # (H, n, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s in range(0, n, block):
        e = min(n, s + block)
        qs = q[s:e].transpose(0, 1)                            # (H, b, hd)
        sc = (qs @ k[:, :e].transpose(1, 2)) * hd ** -0.5      # (H, b, e)
        mask = (torch.arange(e, device=q.device)[None, :]
                > torch.arange(s, e, device=q.device)[:, None])
        sc = sc.masked_fill(mask, float("-inf"))
        out[s:e] = (torch.softmax(sc, dim=-1) @ v[:, :e]).transpose(0, 1)
    return out


def _swiglu(mm, h, w1, w3, w2):
    return mm(torch.nn.functional.silu(mm(h, w1)) * mm(h, w3), w2)


def logits(w, cfg: dict, seqs: List[List[int]], device,
           linear: str = "f32") -> List[torch.Tensor]:
    """(n_i, vocab) float32 logits at every position of each sequence."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits(w, cfg, seqs, torch.device(device), _matmul(linear))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _logits(w, cfg, seqs, device, mm):
    H, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    lens = [len(s) for s in seqs]
    ids = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
    x = w.leaf("embed")[ids]                                   # (N, d)
    starts = [sum(lens[:i]) for i in range(len(lens))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers/{i}/"
        h = _norm(x, w.leaf(p + "ln1"), eps)
        wq, wk, wv, wo = (w.leaf(p + n) for n in ("wq", "wk", "wv", "wo"))
        att = torch.empty(x.shape[0], H * hd, device=device)
        for s0, n in zip(starts, lens):
            hs = h[s0:s0 + n]
            q = _rope(mm(hs, wq).view(n, H, hd), theta)
            k = _rope(mm(hs, wk).view(n, Hkv, hd), theta)
            v = mm(hs, wv).view(n, Hkv, hd)
            att[s0:s0 + n] = _attention(q, k, v).reshape(n, H * hd)
        del wq, wk, wv
        x = x + mm(att, wo)
        del att, wo
        h = _norm(x, w.leaf(p + "ln2"), eps)
        probs = torch.softmax(h @ w.leaf(p + "router"), dim=-1)  # router in f32
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = order.values[:, :K]
        gates = gates / gates.sum(-1, keepdim=True)
        experts = order.indices[:, :K]
        y = torch.zeros_like(x)
        for e in range(E):
            tok, slot = (experts == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            out = _swiglu(mm, h[tok], w.leaf(p + "we1", e), w.leaf(p + "we3", e),
                          w.leaf(p + "we2", e))
            y.index_add_(0, tok, out * gates[tok, slot][:, None])
        if cfg.get("dense_residual_size", 0):
            y = y + _swiglu(mm, h, w.leaf(p + "wd1"), w.leaf(p + "wd3"),
                            w.leaf(p + "wd2"))
        x = x + y
        del h, y
    h = _norm(x, w.leaf("final_norm"), eps)
    head = w.leaf("lm_head")
    out = []
    for s0, n in zip(starts, lens):
        out.append(mm(h[s0:s0 + n], head))
    return out
