"""Dense gated FFN (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation


def gated_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
              w2: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """(..., d) @ (d, ff) gated MLP: act(x@w1) * (x@w3) @ w2."""
    h = activation(x @ w1, act) * (x @ w3)
    return h @ w2
