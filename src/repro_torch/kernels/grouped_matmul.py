"""Grouped (per-expert) matmul: the CUDA kernel ``csrc/grouped_matmul.cu``
and its plain PyTorch version.  A CUDA tensor launches the kernel; a CPU
tensor takes the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_route
from repro_torch.kernels.cuda_build import DTYPE_CODES, CudaKernel, check, ptr

KERNEL = CudaKernel("grouped_matmul.cu", "grouped_matmul",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5)


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, M, K) x (G, K, N) -> (G, M, N), f32 accumulation, x's dtype."""
    return torch.einsum("gmk,gkn->gmn", x.float(), w.float()).to(x.dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if kernel_route(x) == "plain":
        return grouped_matmul_plain(x, w)
    G, M, K = x.shape
    check(w.device == x.device, "grouped_matmul: mixed devices")
    check(w.dim() == 3 and w.shape[0] == G and w.shape[1] == K,
          f"grouped_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    check(x.dtype in DTYPE_CODES and w.dtype == x.dtype,
          f"grouped_matmul: dtypes {x.dtype}, {w.dtype}")
    check(x.is_contiguous() and w.is_contiguous(),
          "grouped_matmul: inputs must be contiguous")
    N = w.shape[2]
    out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.device, ptr(x), ptr(w), ptr(out), G, M, K, N,
                  DTYPE_CODES[x.dtype])
    return out
