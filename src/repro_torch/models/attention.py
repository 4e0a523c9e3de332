"""Attention math: grouped-query attention for prefill (chunked over
queries), single-token decode attention over a ring-buffer KV cache
or, through a block table, over a paged KV pool, and full cross
attention to static source embeddings.

Shapes follow the JAX package:
  q: (B, Sq, H, hd)    k, v: (B, Sk, Hkv, hd)    H = Hkv * rep (GQA).
Plain einsum and softmax in f32, as there; ``decode_attention`` and
``paged_decode_attention`` here are also the plain versions of the
``kernels.decode_attention`` CUDA kernels.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import softcap


def _grouped_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B,Sq,H,hd) x (B,Sk,Hkv,hd) -> (B,Hkv,rep,Sq,Sk) without repeating k."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float())
    return s * scale


def _grouped_out(p: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """(B,Hkv,rep,Sq,Sk) x (B,Sk,Hkv,hd) -> (B,Sq,H,hd)."""
    B, Hkv, rep, Sq, _ = p.shape
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(B, Sq, Hkv * rep, v.shape[-1]).to(out_dtype)


def attention(q, k, v, q_pos, k_pos, *, causal: bool = True, window: int = 0,
              attn_softcap: float = 0.0, q_chunk: int = 1024) -> torch.Tensor:
    """GQA attention, chunked over queries (``causal=False``: every valid
    key, as the whisper encoder attends).

    q_pos: (B, Sq), k_pos: (B, Sk) absolute positions (-1 = invalid slot).
    """
    scale = q.shape[-1] ** -0.5
    outs = []
    for c0 in range(0, q.shape[1], q_chunk):
        qc, qpc = q[:, c0:c0 + q_chunk], q_pos[:, c0:c0 + q_chunk]
        s = _grouped_scores(qc, k, scale)                   # (B,g,r,C,Sk)
        if attn_softcap > 0.0:
            s = softcap(s, attn_softcap)
        ok = (k_pos[:, None, :] >= 0).expand(-1, qpc.shape[1], -1)
        if causal:
            ok = ok & (k_pos[:, None, :] <= qpc[:, :, None])
        if window > 0:
            ok = ok & (k_pos[:, None, :] > (qpc[:, :, None] - window))
        bias = torch.where(ok, 0.0, -1e30)                   # (B,C,Sk)
        p = torch.softmax(s + bias[:, None, None], dim=-1)
        outs.append(_grouped_out(p, v, q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_pos, pos, *, window: int = 0,
                     attn_softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention over a ring-buffer KV cache.

    q: (B, H, hd); k_cache/v_cache: (B, W, Hkv, hd);
    cache_pos: (B, W) absolute position stored in each slot (-1 = empty);
    pos: (B,) absolute position of the query token.  Returns (B, H, hd).
    """
    s = _grouped_scores(q[:, None], k_cache, q.shape[-1] ** -0.5)         # (B,g,r,1,W)
    if attn_softcap > 0.0:
        s = softcap(s, attn_softcap)
    ok = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window > 0:
        ok = ok & (cache_pos > (pos[:, None] - window))
    bias = torch.where(ok, 0.0, -1e30)                       # (B,W)
    p = torch.softmax(s + bias[:, None, None, None, :], dim=-1)
    return _grouped_out(p, v_cache, q.dtype)[:, 0]


def paged_decode_attention(q, k_pages, v_pages, pos_pages, block_table, pos, *,
                           window: int = 0,
                           attn_softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention reading KV through a block table: the
    pages each row's table names are gathered into the dense (B, W) view
    and ``decode_attention`` runs on it (the gather is a pure copy;
    unmapped logical pages read ``cache_pos = -1``).

    q: (B, H, hd); k_pages/v_pages: (P, ps, Hkv, hd); pos_pages: (P, ps)
    int32 position per pool slot (-1 = empty); block_table: (B, n_logical)
    int32 physical page per logical page (-1 = unmapped); pos: (B,)
    int32.  Returns (B, H, hd).
    """
    B, n_logical = block_table.shape
    W = n_logical * k_pages.shape[1]
    bt = block_table.long().clamp(min=0)
    k_cache = k_pages[bt].reshape((B, W) + tuple(k_pages.shape[2:]))
    v_cache = v_pages[bt].reshape((B, W) + tuple(v_pages.shape[2:]))
    mapped = (block_table >= 0)[:, :, None]
    cache_pos = torch.where(mapped, pos_pages[bt], -1).reshape(B, W)
    return decode_attention(q, k_cache, v_cache, cache_pos, pos, window=window,
                            attn_softcap=attn_softcap)


def cross_attention(q, k, v) -> torch.Tensor:
    """Full (non-causal, unmasked) attention to static source embeddings.

    q: (B, Sq, H, hd); k, v: (B, Ssrc, Hkv, hd).  Returns (B, Sq, H, hd)."""
    s = _grouped_scores(q, k, q.shape[-1] ** -0.5)
    return _grouped_out(torch.softmax(s, dim=-1), v, q.dtype)
