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

from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention, paged_decode_attention)
from repro_torch.kernels.gating_dispatch import gating_dispatch  # noqa: F401
from repro_torch.kernels.gating_topk import gating_topk  # noqa: F401
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.models.common import activation


def _grouped_mlp(mm: Callable, xe, w1, w3, w2, act: str,
                 row_valid: Optional[torch.Tensor], idx, n_tokens, out):
    kw = {} if idx is None else dict(idx=idx, n_tokens=n_tokens)
    h = activation(mm(xe, w1, **kw).float(), act)
    h = h * mm(xe, w3, **kw).float()
    y = mm(h.to(xe.dtype), w2, out=out, **kw)
    if row_valid is not None:
        y = torch.mul(y, row_valid[..., None].to(y.dtype), out=out)
    return y


def grouped_mlp(xe, w1, w3, w2, act: str = "silu", row_valid=None, *,
                idx=None, n_tokens=None, out=None):
    """Per-expert gated MLP: (E, C, d) expert buffers -> (E, C, d),
    written into ``out`` where one is given (the last launch's output).

    row_valid: optional (E, C) bool; rows of dropped or empty capacity
    slots come out as exact zeros even where act(0) != 0.  idx: optional
    (E, C) int32 dispatch table with sentinel ``n_tokens``, forwarded to
    the three launches: rows at and past an expert's live count come out
    as zeros and cost no loads."""
    return _grouped_mlp(grouped_matmul, xe, w1, w3, w2, act, row_valid, idx,
                        n_tokens, out)


def grouped_mlp_plain(xe, w1, w3, w2, act: str = "silu", row_valid=None, *,
                      idx=None, n_tokens=None, out=None):
    """``grouped_mlp`` built from the plain grouped matmul on any device
    (the comparison the card's checks hold the kernel path to)."""
    return _grouped_mlp(grouped_matmul_plain, xe, w1, w3, w2, act, row_valid,
                        idx, n_tokens, out)
