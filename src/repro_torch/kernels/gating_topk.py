"""Fused router -> softmax -> top-k -> per-expert counts: the CUDA kernel
``csrc/gating_topk.cu`` and its plain PyTorch version.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``models.moe.route`` then ``routing_counts``).  Both follow
``jax.lax.top_k``'s choice (the JAX oracle ``kernels/ref.py``
``gating_topk_ref``): a chosen expert is never chosen again, also where
the other probabilities underflow to 0, where the TPU kernel repeats
expert 0.

The kernel is ``gating_dispatch``'s front end: one thread-block cluster
per tile of ``TOKENS_PER_CLUSTER`` tokens, d split over its blocks by
``gating_dispatch.chunk_plan``, so its gates and experts are that
kernel's bit for bit.  Up to ``TOKENS_PER_CLUSTER`` tokens (the decode
path) a call is one launch that also counts; more tokens take a second,
one-block launch for the counts (``topk_launches``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_route
from repro_torch.kernels.cuda_build import (DTYPE_CODES, CudaKernel, check,
                                           check_no_grad, ptr)
from repro_torch.kernels.gating_dispatch import (MAX_EXPERTS, MAX_TOP_K,
                                                 TOKENS_PER_CLUSTER, chunk_rows)
from repro_torch.models import moe as moe_lib

KERNEL = CudaKernel("gating_topk.cu", "gating_topk",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6)


def topk_launches(T: int) -> int:
    """CUDA launches, and device ops, of one call at T tokens: 1 up to
    ``TOKENS_PER_CLUSTER`` (the cluster counts), else 2."""
    return 1 if T <= TOKENS_PER_CLUSTER else 2


def gating_topk_plain(x, w_router, top_k: int):
    """(gates (T, K) f32 normalized, experts (T, K) int32, counts (E,)
    int32 routed tokens per expert)."""
    routing = moe_lib.route(x, w_router, top_k)
    counts = moe_lib.routing_counts(routing, w_router.shape[1])
    return routing.gates, routing.experts, counts.to(torch.int32)


def gating_topk(x, w_router, top_k: int):
    """x: (T, d) f32|bf16, w_router: (d, E) f32.  See
    ``gating_topk_plain`` for the outputs."""
    if kernel_route(x) == "plain":
        return gating_topk_plain(x, w_router, top_k)
    check_no_grad("gating_topk", x, w_router)
    check(x.dim() == 2, f"gating_topk: x must be (T, d), got {tuple(x.shape)}")
    T, d = x.shape
    check(w_router.device == x.device, "gating_topk: mixed devices")
    check(w_router.dim() == 2 and w_router.shape[0] == d
          and w_router.dtype == torch.float32,
          "gating_topk: router must be (d, E) f32")
    E = w_router.shape[1]
    check(x.dtype in DTYPE_CODES, f"gating_topk: dtype {x.dtype}")
    check(E <= MAX_EXPERTS and 0 < top_k <= min(E, MAX_TOP_K),
          f"gating_topk: E={E}, top_k={top_k}")
    check(x.is_contiguous() and w_router.is_contiguous(),
          "gating_topk: inputs must be contiguous")
    check(x.data_ptr() % 16 == 0 and w_router.data_ptr() % 16 == 0,
          "gating_topk: x and the router must start on a 16-byte boundary")
    dev = x.device
    gates = torch.empty((T, top_k), dtype=torch.float32, device=dev)
    experts = torch.empty((T, top_k), dtype=torch.int32, device=dev)
    counts = torch.empty((E,), dtype=torch.int32, device=dev)
    KERNEL.launch(dev, ptr(x), ptr(w_router), ptr(gates), ptr(experts),
                  ptr(counts), T, d, E, top_k, chunk_rows(d), DTYPE_CODES[x.dtype])
    return gates, experts, counts
