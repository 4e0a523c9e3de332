"""Grouped (per-expert) matmul: the CUDA kernel ``csrc/grouped_matmul.cu``
and its plain PyTorch version.  A CUDA tensor launches the kernel; a CPU
tensor takes the plain version."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.device import kernel_route
from repro_torch.kernels.cuda_build import (DTYPE_CODES, CudaKernel, check,
                                           check_no_grad, ptr)

# launches are also counted by branch: "live_rows" (given a dispatch
# table) and "wgmma" (the live-row body)
KERNEL = CudaKernel("grouped_matmul.cu", "grouped_matmul",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7,
                    variants=("live_rows", "wgmma"))

# the kernel's compute body: "auto" picks by shape (f32 FMAs; bf16 FMAs or
# tensor-core strips up to FMA_MAX_M rows, the live-row wgmma body above);
# "fma" / "mma" force a strip body, to time it beside the one picked
BODIES = {"auto": 0, "fma": 1, "mma": 2}
FMA_MAX_M = 8


def live_rows(idx: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """(G,) 1 + the last slot of each row of the (G, C) dispatch table
    that is not the sentinel ``n_tokens``; 0 where every slot is empty."""
    pos = torch.arange(1, idx.shape[1] + 1, device=idx.device)
    return torch.where(idx != n_tokens, pos, 0).amax(dim=1)


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                         idx: Optional[torch.Tensor] = None,
                         n_tokens: Optional[int] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(G, M, K) x (G, K, N) -> (G, M, N), f32 accumulation, x's dtype
    (written into ``out`` where one is given).  With the (G, M) dispatch
    table ``idx`` (sentinel ``n_tokens``), the rows of each expert at and
    past its live count are exact zeros."""
    y = torch.einsum("gmk,gkn->gmn", x.float(), w.float()).to(x.dtype)
    if idx is not None:
        live = live_rows(idx, n_tokens)
        rows = torch.arange(x.shape[1], device=x.device)
        y = torch.where((rows < live[:, None])[..., None], y, y.new_zeros(()))
    return y if out is None else out.copy_(y)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, body: str = "auto",
                   idx: Optional[torch.Tensor] = None,
                   n_tokens: Optional[int] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``grouped_matmul_plain``'s function (``out``: a contiguous (G, M, N)
    tensor of x's dtype and device to write into).  On the card, with
    ``idx`` a block loads nothing for rows past its expert's live count,
    and an expert with no live row streams none of its weights."""
    if out is not None:
        check(tuple(out.shape) == (x.shape[0], x.shape[1], w.shape[2])
              and out.dtype == x.dtype and out.device == x.device
              and out.is_contiguous(),
              f"grouped_matmul: out must be a contiguous "
              f"({x.shape[0]}, {x.shape[1]}, {w.shape[2]}) {x.dtype} tensor")
    if kernel_route(x) == "plain":
        return grouped_matmul_plain(x, w, idx=idx, n_tokens=n_tokens, out=out)
    check_no_grad("grouped_matmul", x, w)
    G, M, K = x.shape
    check(w.device == x.device, "grouped_matmul: mixed devices")
    check(w.dim() == 3 and w.shape[0] == G and w.shape[1] == K,
          f"grouped_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    check(x.dtype in DTYPE_CODES and w.dtype == x.dtype,
          f"grouped_matmul: dtypes {x.dtype}, {w.dtype}")
    check(x.is_contiguous() and w.is_contiguous(),
          "grouped_matmul: inputs must be contiguous")
    check(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
          and (out is None or out.data_ptr() % 16 == 0),
          "grouped_matmul: x, w and out must start on a 16-byte boundary")
    check(body in BODIES and (body != "mma" or x.dtype == torch.bfloat16),
          f"grouped_matmul: body {body!r} for {x.dtype}")
    if idx is not None:
        check(n_tokens is not None, "grouped_matmul: idx needs n_tokens")
        check(tuple(idx.shape) == (G, M) and idx.dtype == torch.int32
              and idx.is_contiguous() and idx.device == x.device,
              f"grouped_matmul: idx must be ({G}, {M}) contiguous int32 on "
              f"x's device")
    N = w.shape[2]
    if out is None:
        out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    wgmma = x.dtype == torch.bfloat16 and body == "auto" and M > FMA_MAX_M
    KERNEL.launch(x.device, ptr(x), ptr(w), ptr(out),
                  None if idx is None else ptr(idx), G, M, K, N,
                  -1 if idx is None else int(n_tokens), DTYPE_CODES[x.dtype],
                  BODIES[body],
                  variants=(("live_rows",) if idx is not None else ())
                  + (("wgmma",) if wgmma else ()))
    return out
