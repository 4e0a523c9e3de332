"""Flash-decode GQA attention: the CUDA kernel ``csrc/decode_attention.cu``
and its plain PyTorch version.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``models.attention.decode_attention``, the same math as the JAX
package's ``kernels/ref.py`` oracle).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_route
from repro_torch.kernels.cuda_build import DTYPE_CODES, CudaKernel, check, ptr
from repro_torch.models.attention import decode_attention as decode_attention_plain

KERNEL = CudaKernel(
    "decode_attention.cu", "decode_attention",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
    + [ctypes.c_int])

MAX_REP = 16


def decode_attention(q, k_cache, v_cache, cache_pos, pos, *, window: int = 0,
                     attn_softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, hd); k/v cache: (B, W, Hkv, hd); cache_pos: (B, W) int32
    (-1 = empty); pos: (B,) int32.  Returns (B, H, hd) in q's dtype."""
    if kernel_route(q) == "plain":
        return decode_attention_plain(q, k_cache, v_cache, cache_pos, pos,
                                      window=window, attn_softcap=attn_softcap)
    B, H, hd = q.shape
    _, W, Hkv, _ = k_cache.shape
    for t in (k_cache, v_cache, cache_pos, pos):
        check(t.device == q.device, "decode_attention: mixed devices")
    for t in (q, k_cache, v_cache, cache_pos, pos):
        check(t.is_contiguous(), "decode_attention: inputs must be contiguous")
    check(q.dtype in DTYPE_CODES, f"decode_attention: dtype {q.dtype}")
    check(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype,
          "decode_attention: q and the cache must share a dtype")
    check(cache_pos.dtype == torch.int32 and pos.dtype == torch.int32,
          "decode_attention: positions must be int32")
    check(tuple(v_cache.shape) == (B, W, Hkv, hd) and k_cache.shape[0] == B
          and k_cache.shape[3] == hd, "decode_attention: cache shape")
    check(tuple(cache_pos.shape) == (B, W) and tuple(pos.shape) == (B,),
          "decode_attention: position shapes")
    check(hd in (64, 128), f"decode_attention: head_dim {hd} not in (64, 128)")
    check(H % Hkv == 0 and H // Hkv <= MAX_REP,
          f"decode_attention: {H} heads over {Hkv} kv heads")
    out = torch.empty_like(q)
    KERNEL.launch(q.device, ptr(q), ptr(k_cache), ptr(v_cache), ptr(cache_pos),
                  ptr(pos), ptr(out), B, H, Hkv, W, hd, int(window),
                  float(attn_softcap), float(hd ** -0.5), DTYPE_CODES[q.dtype])
    return out
