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
    block and the partial products are summed over the axis (inside a
    sequence-parallel region, reduce-scattered to the rank's block of
    the sequence; an FFN the rules left whole is cut to it)."""
    mp = parallel.current()
    if mp is not None and d_ff is not None and mp.block(d_ff, w1.shape[-1]):
        return mp.reduce_act(_gated(mp.enter_seq(x), w1, w3, w2, act))
    return parallel.seq_block(_gated(x, w1, w3, w2, act))


def _gated(x, w1, w3, w2, act):
    return (activation(x @ w1, act) * (x @ w3)) @ w2
