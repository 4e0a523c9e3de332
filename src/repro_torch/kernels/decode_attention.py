"""Flash-decode GQA attention over a ring-buffer KV cache
(``csrc/decode_attention.cu``) and over a paged KV pool through a block
table (``csrc/paged_decode_attention.cu``), each with its plain PyTorch
version.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``models.attention.decode_attention`` / ``paged_decode_attention``, the
same math as the JAX package's ``kernels/ref.py`` oracle).
``decode_attention(partial=True)`` is the branch for a block of the
ring's slots (``models.attention.decode_attention_partial`` its plain
version): each row with its log-sum-exp, merged across ranks by
``models.parallel.merge_partials``.

Both kernels are one split kernel and one merge kernel
(``csrc/decode_split.cuh``), flash-decoding: ``split_plan`` picks the
number of splits of the W logical slots from the shapes alone, each
split writes a partial (acc, max, sum) to a scratch buffer allocated
here, and the same C entry point merges them in a fixed order.  The
paged kernel splits its ``n_logical * ps`` logical slots as the ring
kernel splits a ring of that width, so over one pool it is
bit-identical to ``decode_attention`` over ``PagePool.gather``'s view.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_route
from repro_torch.kernels.cuda_build import (DTYPE_CODES, CudaKernel, check,
                                           check_no_grad, ptr)
from repro_torch.models.attention import decode_attention as decode_attention_plain
from repro_torch.models.attention import \
    decode_attention_partial as decode_attention_partial_plain
from repro_torch.models.attention import \
    paged_decode_attention as paged_decode_attention_plain

# launches of the partial branch are also counted under "partial"
KERNEL = CudaKernel(
    "decode_attention.cu", "decode_attention",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
    + [ctypes.c_int], variants=("partial",))

PAGED_KERNEL = CudaKernel(
    "paged_decode_attention.cu", "paged_decode_attention",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
    + [ctypes.c_int])

MAX_REP = 16
HEAD_DIMS = (64, 128, 256)   # the split kernel's instantiations
TILE = 32                 # logical slots per tile of the split kernel
TARGET_BLOCKS = 4 * 132   # four resident blocks on each of the H100's SMs
MAX_SPLITS = 64           # the merge kernel's limit


def split_plan(B: int, Hkv: int, W: int):
    """(splits, tiles per split) of the split kernel over W logical
    slots: enough splits of the 32-slot tiles for about
    ``TARGET_BLOCKS`` blocks of (kv head, row, split), at most
    ``MAX_SPLITS``, none empty.  A function of the shapes only, so the
    result never depends on the data."""
    tiles = -(-W // TILE)
    want = max(1, min(tiles, MAX_SPLITS, -(-TARGET_BLOCKS // (B * Hkv))))
    per = -(-tiles // want)
    return -(-tiles // per), per


def scratch_shape(B: int, H: int, Hkv: int, hd: int, W: int):
    """Shape of the f32 scratch of the split partials: per (row, kv
    head, split, query head of the group) the unnormalised accumulator
    (hd), the running max and the running sum."""
    return (B, Hkv, split_plan(B, Hkv, W)[0], H // Hkv, hd + 2)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def decode_attention(q, k_cache, v_cache, cache_pos, pos, *, window: int = 0,
                     attn_softcap: float = 0.0, partial: bool = False):
    """q: (B, H, hd); k/v cache: (B, W, Hkv, hd); cache_pos: (B, W) int32
    (-1 = empty); pos: (B,) int32.  Returns (B, H, hd) in q's dtype.

    ``partial``: the slots given are a block of the ring (a rank's); returns
    (out (B, H, hd) f32, lse (B, H) f32), each row over those slots and its
    log-sum-exp (out 0 and lse -inf for a row with no valid slot), for
    ``models.parallel.merge_partials``."""
    if kernel_route(q) == "plain":
        fn = decode_attention_partial_plain if partial else decode_attention_plain
        return fn(q, k_cache, v_cache, cache_pos, pos, window=window,
                  attn_softcap=attn_softcap)
    check_no_grad("decode_attention", q, k_cache, v_cache)
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
    check(hd in HEAD_DIMS, f"decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    check(H % Hkv == 0 and H // Hkv <= MAX_REP,
          f"decode_attention: {H} heads over {Hkv} kv heads")
    check(_aligned(q, k_cache, v_cache),
          "decode_attention: q, k and v must start on a 16-byte boundary")
    nsplit, per = split_plan(B, Hkv, W)
    part = torch.empty(scratch_shape(B, H, Hkv, hd, W), dtype=torch.float32,
                       device=q.device)
    if partial:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    else:
        out, lse = torch.empty_like(q), None
    KERNEL.launch(q.device, ptr(q), ptr(k_cache), ptr(v_cache), ptr(cache_pos),
                  ptr(pos), ptr(part), ptr(out),
                  ptr(lse) if partial else ctypes.c_void_p(None), B, H, Hkv, W,
                  hd, nsplit, per, int(window), float(attn_softcap),
                  float(hd ** -0.5), DTYPE_CODES[q.dtype],
                  variants=("partial",) if partial else ())
    return (out, lse) if partial else out


def paged_decode_attention(q, k_pages, v_pages, pos_pages, block_table, pos, *,
                           window: int = 0,
                           attn_softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, hd); k/v pages: (P, ps, Hkv, hd); pos_pages: (P, ps)
    int32 (-1 = empty); block_table: (B, n_logical) int32 (-1 =
    unmapped); pos: (B,) int32.  Returns (B, H, hd) in q's dtype.

    Every table entry must be -1 or below P.  The CPU route checks it;
    on the card the kernel reads the table as it is, so there it is the
    caller's contract (the engine's tables hold only pool page ids)."""
    if kernel_route(q) == "plain":
        check(bool((block_table < k_pages.shape[0]).all()),
              "paged_decode_attention: block table entry >= pool size")
        return paged_decode_attention_plain(q, k_pages, v_pages, pos_pages,
                                            block_table, pos, window=window,
                                            attn_softcap=attn_softcap)
    check_no_grad("paged_decode_attention", q, k_pages, v_pages)
    B, H, hd = q.shape
    P, ps, Hkv, _ = k_pages.shape
    check(block_table.dim() == 2 and block_table.shape[0] == B,
          "paged_decode_attention: table must be (B, n_logical)")
    n_logical = block_table.shape[1]
    for t in (k_pages, v_pages, pos_pages, block_table, pos):
        check(t.device == q.device, "paged_decode_attention: mixed devices")
    for t in (q, k_pages, v_pages, pos_pages, block_table, pos):
        check(t.is_contiguous(),
              "paged_decode_attention: inputs must be contiguous")
    check(q.dtype in DTYPE_CODES, f"paged_decode_attention: dtype {q.dtype}")
    check(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
          "paged_decode_attention: q and the pages must share a dtype")
    check(pos_pages.dtype == torch.int32 and block_table.dtype == torch.int32
          and pos.dtype == torch.int32,
          "paged_decode_attention: positions and the table must be int32")
    check(tuple(v_pages.shape) == (P, ps, Hkv, hd) and k_pages.shape[3] == hd,
          "paged_decode_attention: page shape")
    check(tuple(pos_pages.shape) == (P, ps) and tuple(pos.shape) == (B,),
          "paged_decode_attention: position shapes")
    check(hd in HEAD_DIMS,
          f"paged_decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    check(H % Hkv == 0 and H // Hkv <= MAX_REP,
          f"paged_decode_attention: {H} heads over {Hkv} kv heads")
    check(_aligned(q, k_pages, v_pages),
          "paged_decode_attention: q, k and v must start on a 16-byte boundary")
    # the plan of a ring of n_logical * ps slots, the width of
    # PagePool.gather's view: the two kernels run the same arithmetic
    nsplit, per = split_plan(B, Hkv, n_logical * ps)
    part = torch.empty(scratch_shape(B, H, Hkv, hd, n_logical * ps),
                       dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    PAGED_KERNEL.launch(q.device, ptr(q), ptr(k_pages), ptr(v_pages),
                        ptr(pos_pages), ptr(block_table), ptr(pos), ptr(part),
                        ptr(out), B, H, Hkv, ps, n_logical, hd, nsplit, per,
                        int(window), float(attn_softcap), float(hd ** -0.5),
                        DTYPE_CODES[q.dtype])
    return out
