"""Fused router -> top-k -> dispatch-index build: the CUDA kernel
``csrc/gating_dispatch.cu`` and its plain PyTorch version.

The plain version takes the JAX ``gating_dispatch`` contract in full
(router bias, count weights, live-placement replica tables, owner
filter).  The CUDA kernel covers what the serving path uses: bias and
count weights, no tables, no owner; the wrapper raises
``NotImplementedError`` for the rest until the m2n and live-placement
slices port them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_route
from repro_torch.kernels.cuda_build import DTYPE_CODES, CudaKernel, check, ptr
from repro_torch.models import moe as moe_lib

KERNEL = CudaKernel("gating_dispatch.cu", "gating_dispatch",
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6)

MAX_EXPERTS = 256
MAX_TOP_K = 16


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
    bias = (torch.zeros(E, dtype=torch.float32, device=dev) if bias is None
            else bias.to(torch.float32))
    cw = (torch.ones(T, dtype=torch.float32, device=dev) if count_weights is None
          else count_weights.to(torch.float32))
    for t in (w_router, bias, cw):
        check(t.device == dev, "gating_dispatch: mixed devices")
    check(tuple(bias.shape) == (E,) and tuple(cw.shape) == (T,),
          "gating_dispatch: bias (E,) and count_weights (T,)")
    x, w_router = x.contiguous(), w_router.contiguous()
    bias, cw = bias.contiguous(), cw.contiguous()
    gates = torch.empty((T, top_k), dtype=torch.float32, device=dev)
    experts = torch.empty((T, top_k), dtype=torch.int32, device=dev)
    idx_buf = torch.empty((E, capacity), dtype=torch.int32, device=dev)
    gate_buf = torch.empty((E, capacity), dtype=torch.float32, device=dev)
    counts = torch.empty((E,), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, ptr(x), ptr(w_router), ptr(bias), ptr(cw), ptr(gates),
                  ptr(experts), ptr(idx_buf), ptr(gate_buf), ptr(counts),
                  T, d, E, top_k, capacity, DTYPE_CODES[x.dtype])
    return idx_buf, gate_buf, counts
