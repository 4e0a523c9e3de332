"""Fused router -> top-k -> dispatch-index build: the CUDA kernel
``csrc/gating_dispatch.cu`` and its plain PyTorch version.

The plain version takes the JAX ``gating_dispatch`` contract in full
(router bias, count weights, live-placement replica tables, owner
filter).  The CUDA kernel covers what the serving path uses: bias and
count weights, no tables, no owner; the wrapper raises
``NotImplementedError`` for the rest until the m2n and live-placement
slices port them.

The kernel splits d over a thread-block cluster of ``CLUSTER`` blocks
(``chunk_plan``) and sums the blocks' partial logits in chunk order.
Up to ``TOKENS_PER_CLUSTER`` tokens (the decode path) it is one launch
of one cluster, whose first block also builds the capacity slots; more
tokens take one cluster per tile of tokens and a second, one-block
launch for the slots (``dispatch_launches``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_route
from repro_torch.kernels.cuda_build import DTYPE_CODES, CudaKernel, check, ptr
from repro_torch.models import moe as moe_lib

KERNEL = CudaKernel("gating_dispatch.cu", "gating_dispatch",
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7)

MAX_EXPERTS = 256
MAX_TOP_K = 16
CLUSTER = 8               # blocks per cluster; d is split this many ways
CHUNK_ALIGN = 8           # a block's rows of d start on a multiple of 8
TOKENS_PER_CLUSTER = 16   # tokens one cluster routes


def chunk_rows(d: int, n_chunks: int = CLUSTER) -> int:
    """Rows of d per block: d / n_chunks rounded up to a multiple of
    ``CHUNK_ALIGN``, so every chunk's rows of x and of the router start
    on a 16-byte boundary."""
    return -(-(-(-d // n_chunks)) // CHUNK_ALIGN) * CHUNK_ALIGN


def chunk_plan(d: int, n_chunks: int = CLUSTER):
    """The rows of d each block of the cluster sums, as (start, stop)
    pairs in the order their partial logits are added; the last chunks
    may be ragged or empty."""
    per = chunk_rows(d, n_chunks)
    return [(min(d, c * per), min(d, (c + 1) * per)) for c in range(n_chunks)]


def dispatch_launches(T: int) -> int:
    """CUDA launches of one call at T tokens: 1 up to
    ``TOKENS_PER_CLUSTER`` (the cluster builds the slots), else 2."""
    return 1 if T <= TOKENS_PER_CLUSTER else 2


def gating_dispatch_plain(x, w_router, top_k: int, n_buckets: int,
                          capacity: int, *, bias=None, count_weights=None,
                          owner=None, rep_node=None, rep_slot=None,
                          rep_cum=None, slots_per_node: int = 0):
    """The route -> replica_assign -> dispatch_indices chain.  Returns
    (idx_buf (rows, C) int32, sentinel T = empty; gate_buf (rows, C) f32;
    counts (E,) f32 weighted per-expert routed-token counts)."""
    if not slots_per_node:
        slots_per_node = n_buckets
    routing = moe_lib.route(x, w_router, top_k, bias)
    counts = moe_lib.routing_counts(routing, w_router.shape[1], count_weights)
    if rep_node is not None:
        vslot, node = moe_lib.replica_assign(routing.experts, rep_node,
                                             rep_slot, rep_cum, slots_per_node)
    else:
        vslot = routing.experts
        node = torch.div(vslot, slots_per_node, rounding_mode="floor")
    if owner is not None:
        valid = node == owner
        local = torch.where(valid, vslot - owner * slots_per_node, 0)
        r = moe_lib.Routing(routing.gates, local, routing.probs)
        idx_buf, gate_buf = moe_lib.dispatch_indices(r, slots_per_node,
                                                     capacity, valid=valid)
    else:
        r = moe_lib.Routing(routing.gates, vslot, routing.probs)
        idx_buf, gate_buf = moe_lib.dispatch_indices(r, n_buckets, capacity)
    return idx_buf, gate_buf, counts


def gating_dispatch(x, w_router, top_k: int, n_buckets: int, capacity: int,
                    *, bias=None, count_weights=None, owner=None,
                    rep_node=None, rep_slot=None, rep_cum=None,
                    slots_per_node: int = 0):
    """x: (T, d) f32|bf16, w_router: (d, E) f32.  See
    ``gating_dispatch_plain`` for the outputs."""
    if kernel_route(x) == "plain":
        return gating_dispatch_plain(
            x, w_router, top_k, n_buckets, capacity, bias=bias,
            count_weights=count_weights, owner=owner, rep_node=rep_node,
            rep_slot=rep_slot, rep_cum=rep_cum, slots_per_node=slots_per_node)
    if owner is not None or rep_node is not None:
        raise NotImplementedError(
            "gating_dispatch's CUDA kernel has no owner filter or placement "
            "tables yet (m2n and live-placement slices)")
    T, d = x.shape
    E = w_router.shape[1]
    dev = x.device
    check(n_buckets == E, f"gating_dispatch: {n_buckets} buckets for {E} experts")
    check(tuple(w_router.shape) == (d, E) and w_router.dtype == torch.float32,
          "gating_dispatch: router must be (d, E) f32")
    check(x.dtype in DTYPE_CODES, f"gating_dispatch: dtype {x.dtype}")
    check(E <= MAX_EXPERTS and 0 < top_k <= min(E, MAX_TOP_K),
          f"gating_dispatch: E={E}, top_k={top_k}")
    check(capacity > 0, "gating_dispatch: capacity must be positive")
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    cw = (None if count_weights is None
          else count_weights.to(torch.float32).contiguous())
    check(bias is None or (tuple(bias.shape) == (E,) and bias.device == dev),
          "gating_dispatch: bias must be (E,) on x's device")
    check(cw is None or (tuple(cw.shape) == (T,) and cw.device == dev),
          "gating_dispatch: count_weights must be (T,) on x's device")
    check(w_router.device == dev, "gating_dispatch: mixed devices")
    x, w_router = x.contiguous(), w_router.contiguous()
    check(x.data_ptr() % 16 == 0 and w_router.data_ptr() % 16 == 0,
          "gating_dispatch: x and the router must start on a 16-byte boundary")
    scratch = [None, None]
    if dispatch_launches(T) == 2:
        scratch = [torch.empty((T, top_k), dtype=torch.float32, device=dev),
                   torch.empty((T, top_k), dtype=torch.int32, device=dev)]
    idx_buf = torch.empty((E, capacity), dtype=torch.int32, device=dev)
    gate_buf = torch.empty((E, capacity), dtype=torch.float32, device=dev)
    counts = torch.empty((E,), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, ptr(x), ptr(w_router), _ptr_or_null(bias),
                  _ptr_or_null(cw), *map(_ptr_or_null, scratch), ptr(idx_buf),
                  ptr(gate_buf), ptr(counts), T, d, E, top_k, capacity,
                  chunk_rows(d), DTYPE_CODES[x.dtype])
    return idx_buf, gate_buf, counts


def _ptr_or_null(t):
    return None if t is None else ptr(t)
