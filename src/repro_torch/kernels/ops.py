"""Public kernel entry points of the port.

Each op launches its hand-written CUDA kernel for CUDA tensors and takes
its plain PyTorch version for CPU tensors (no fallback between the two:
a CUDA launch that fails raises).  ``grouped_mlp`` stays composed of
three ``grouped_matmul`` launches with the activation and the gate
multiply as plain torch between them, as the JAX package composes it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention  # noqa: F401
from repro_torch.kernels.gating_dispatch import gating_dispatch  # noqa: F401
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.models.common import activation


def _grouped_mlp(mm: Callable, xe, w1, w3, w2, act: str,
                 row_valid: Optional[torch.Tensor]):
    h = activation(mm(xe, w1).float(), act)
    h = h * mm(xe, w3).float()
    out = mm(h.to(xe.dtype), w2)
    if row_valid is not None:
        out = out * row_valid[..., None].to(out.dtype)
    return out


def grouped_mlp(xe, w1, w3, w2, act: str = "silu", row_valid=None):
    """Per-expert gated MLP: (E, C, d) expert buffers -> (E, C, d).

    row_valid: optional (E, C) bool; rows of dropped or empty capacity
    slots come out as exact zeros even where act(0) != 0."""
    return _grouped_mlp(grouped_matmul, xe, w1, w3, w2, act, row_valid)


def grouped_mlp_plain(xe, w1, w3, w2, act: str = "silu", row_valid=None):
    """``grouped_mlp`` built from the plain grouped matmul on any device
    (the comparison the card's checks hold the kernel path to)."""
    return _grouped_mlp(grouped_matmul_plain, xe, w1, w3, w2, act, row_valid)
