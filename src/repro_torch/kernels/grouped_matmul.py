"""Grouped (per-expert) matmul: the CUDA kernel ``csrc/grouped_matmul.cu``
and its plain PyTorch version.  A CUDA tensor launches the kernel; a CPU
tensor takes the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import kernel_route
from repro_torch.kernels.cuda_build import (DTYPE_CODES, CudaKernel, check,
                                           check_no_grad, ptr)

KERNEL = CudaKernel("grouped_matmul.cu", "grouped_matmul",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6)

# the kernel's compute body: "auto" picks by shape (f32 FMAs; bf16 FMAs
# up to 8 rows, tensor cores above); "fma" / "mma" force one, to time both
BODIES = {"auto": 0, "fma": 1, "mma": 2}


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, M, K) x (G, K, N) -> (G, M, N), f32 accumulation, x's dtype."""
    return torch.einsum("gmk,gkn->gmn", x.float(), w.float()).to(x.dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   body: str = "auto") -> torch.Tensor:
    if kernel_route(x) == "plain":
        return grouped_matmul_plain(x, w)
    check_no_grad("grouped_matmul", x, w)
    G, M, K = x.shape
    check(w.device == x.device, "grouped_matmul: mixed devices")
    check(w.dim() == 3 and w.shape[0] == G and w.shape[1] == K,
          f"grouped_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    check(x.dtype in DTYPE_CODES and w.dtype == x.dtype,
          f"grouped_matmul: dtypes {x.dtype}, {w.dtype}")
    check(x.is_contiguous() and w.is_contiguous(),
          "grouped_matmul: inputs must be contiguous")
    check(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
          "grouped_matmul: x and w must start on a 16-byte boundary")
    check(body in BODIES and (body != "mma" or x.dtype == torch.bfloat16),
          f"grouped_matmul: body {body!r} for {x.dtype}")
    N = w.shape[2]
    out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.device, ptr(x), ptr(w), ptr(out), G, M, K, N,
                  DTYPE_CODES[x.dtype], BODIES[body])
    return out
