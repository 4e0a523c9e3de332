"""Dense gated FFN (SwiGLU / GeGLU)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import parallel
from repro_torch.models.common import activation


def gated_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
              w2: torch.Tensor, act: str = "silu",
              d_ff: Optional[int] = None) -> torch.Tensor:
    """(..., d) @ (d, ff) gated MLP: act(x@w1) * (x@w3) @ w2.

    ``d_ff``: the full hidden width.  Where an installed model axis
    (``models.parallel``) leaves this rank only its block of the d_ff
    columns of ``w1`` / ``w3`` and rows of ``w2``, x enters the rank's
    block and the partial products are summed over the axis."""
    mp = parallel.current()
    if mp is not None and d_ff is not None and mp.block(d_ff, w1.shape[-1]):
        return mp.reduce(gated_ffn(mp.enter(x), w1, w3, w2, act))
    h = activation(x @ w1, act) * (x @ w3)
    return h @ w2
