"""Fused router -> top-k -> dispatch-index build: the CUDA kernel
``csrc/gating_dispatch.cu`` and its plain PyTorch version.

Both take the JAX ``gating_dispatch`` contract in full: router bias,
count weights, the live-placement replica tables and the owner filter.
With the tables (``rep_node``/``rep_slot``/``rep_cum``, (E, R)) each
(token, k) entry goes to one replica of its expert, picked by the
token-index hash against the replicas' cumulative traffic shares, and
its bucket is that replica's virtual slot ``node * S + slot``.  With
``owner`` only the entries of that expert node take a slot, and the
buffers are the node's ``slots_per_node`` rows.  The counts stay per
routed expert and cover every entry.

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
from repro_torch.kernels.cuda_build import (DTYPE_CODES, CudaKernel, check,
                                           check_no_grad, ptr)
from repro_torch.models import moe as moe_lib

# launches are also counted by branch: "tables" (placement tables) and
# "owner" (the m2n owner filter); a call with both counts in both
KERNEL = CudaKernel("gating_dispatch.cu", "gating_dispatch",
                    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11,
                    variants=("tables", "owner"))

MAX_EXPERTS = 256
MAX_ROWS = 256            # rows of the output buffers
MAX_TABLE = 4096          # E * R entries of each placement table
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
    check_no_grad("gating_dispatch", x, w_router, bias, count_weights)
    T, d = x.shape
    E = w_router.shape[1]
    dev = x.device
    if not slots_per_node:
        slots_per_node = n_buckets
    rows = slots_per_node if owner is not None else n_buckets
    tables = rep_node is not None
    check(tuple(w_router.shape) == (d, E) and w_router.dtype == torch.float32,
          "gating_dispatch: router must be (d, E) f32")
    check(x.dtype in DTYPE_CODES, f"gating_dispatch: dtype {x.dtype}")
    check(E <= MAX_EXPERTS and 0 < top_k <= min(E, MAX_TOP_K),
          f"gating_dispatch: E={E}, top_k={top_k}")
    check(capacity > 0, "gating_dispatch: capacity must be positive")
    check(0 < rows <= MAX_ROWS and slots_per_node > 0,
          f"gating_dispatch: {rows} rows, {slots_per_node} slots per node")
    check(tables or n_buckets >= E,
          f"gating_dispatch: {n_buckets} buckets for {E} experts")
    check(owner is None or 0 <= owner < -(-n_buckets // slots_per_node),
          f"gating_dispatch: owner {owner} of {n_buckets} buckets")
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    cw = (None if count_weights is None
          else count_weights.to(torch.float32).contiguous())
    check(bias is None or (tuple(bias.shape) == (E,) and bias.device == dev),
          "gating_dispatch: bias must be (E,) on x's device")
    check(cw is None or (tuple(cw.shape) == (T,) and cw.device == dev),
          "gating_dispatch: count_weights must be (T,) on x's device")
    check(w_router.device == dev, "gating_dispatch: mixed devices")
    tbl, R = [None] * 3, 0
    if tables:
        tbl = [t.to(dt).contiguous() for t, dt in ((rep_node, torch.int32),
                                                   (rep_slot, torch.int32),
                                                   (rep_cum, torch.float32))]
        R = tbl[0].shape[-1]
        check(all(tuple(t.shape) == (E, R) and t.device == dev for t in tbl)
              and 0 < E * R <= MAX_TABLE,
              f"gating_dispatch: placement tables must be (E, R) on x's device "
              f"with E * R <= {MAX_TABLE}")
    x, w_router = x.contiguous(), w_router.contiguous()
    check(x.data_ptr() % 16 == 0 and w_router.data_ptr() % 16 == 0,
          "gating_dispatch: x and the router must start on a 16-byte boundary")
    scratch = [None, None]
    if dispatch_launches(T) == 2:
        scratch = [torch.empty((T, top_k), dtype=torch.float32, device=dev),
                   torch.empty((T, top_k), dtype=torch.int32, device=dev)]
    idx_buf = torch.empty((rows, capacity), dtype=torch.int32, device=dev)
    gate_buf = torch.empty((rows, capacity), dtype=torch.float32, device=dev)
    counts = torch.empty((E,), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, ptr(x), ptr(w_router), _ptr_or_null(bias),
                  _ptr_or_null(cw), *map(_ptr_or_null, tbl),
                  *map(_ptr_or_null, scratch), ptr(idx_buf), ptr(gate_buf),
                  ptr(counts), T, d, E, top_k, capacity, chunk_rows(d), R,
                  slots_per_node, -1 if owner is None else int(owner), rows,
                  DTYPE_CODES[x.dtype],
                  variants=(("tables",) if tables else ())
                  + (("owner",) if owner is not None else ()))
    return idx_buf, gate_buf, counts


def _ptr_or_null(t):
    return None if t is None else ptr(t)
