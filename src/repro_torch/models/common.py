"""Shared model building blocks: norms, RoPE, softcap, init helpers."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, scaled by ``1 + scale``, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved pairs).

    x: (..., seq, n_heads, head_dim), positions: (..., seq) int.
    """
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., seq, hd/2)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(act)


# an f32 draw above this many bytes, for a lower-precision tensor, is made
# one slice of the leading axis at a time (arctic-480b's 128 experts)
_SLICED_DRAW_BYTES = 4 * 2 ** 30


def _trunc_normal(gen, shape, device, std) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=gen)
    return t.mul_(std)


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init, drawn in f32 then cast.
    A large tensor of a narrower dtype is drawn slice by slice along its
    first axis, so the f32 draw never holds more than one slice."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    if (dtype != torch.float32 and len(shape) >= 3
            and 4 * math.prod(shape) > _SLICED_DRAW_BYTES):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = _trunc_normal(gen, shape[1:], device, std).to(dtype)
        return out
    return _trunc_normal(gen, shape, device, std).to(dtype)
