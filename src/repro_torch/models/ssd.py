"""Mamba-2 SSD (state-space duality) block, arXiv:2405.21060, the JAX
package's ``models/ssd.py`` in PyTorch.

Sequence mode is the chunked SSD algorithm (paper listing 1): quadratic
attention-like computation inside fixed-size chunks, a linear
recurrence across chunk states.  Decode mode is the classic single-step
state update.  Single head-group (g = 1): B and C are shared across
heads.

The recurrence across chunk states runs as a loop over the chunks here;
the JAX package runs it as an ``associative_scan``.  The same products
and sums in another order: the two agree to f32 rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig
from repro_torch.models.common import rms_norm
from repro_torch.models.rglru import causal_conv1d


def segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = sum_{k=j+1..i} x_k  (-inf for j > i).

    The masked entries are set to -inf after the cumulative sum, never
    subtracted, so ``exp`` of the result is an exact 0 above the
    diagonal."""
    T = x.shape[-1]
    xr = x[..., :, None].expand(*x.shape, T)                 # xr[..., i, j] = x_i
    lower = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device), -1)
    s = torch.cumsum(torch.where(lower, xr, 0.0), dim=-2)
    incl = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device), 0)
    return torch.where(incl, s, -torch.inf)


def ssd_chunked(x: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None):
    """Chunked SSD.

    x:   (b, l, h, p)  inputs already scaled by dt
    dtA: (b, l, h)     dt * A (negative)
    B,C: (b, l, n)     input/output projections (shared across heads)
    Returns (y: (b, l, h, p), final_state: (b, h, p, n)) in f32.

    A length that is not a whole number of chunks is padded with zeros
    (dtA = 0: decay 1; x = 0: no input), so the final state is the state
    after the last real token."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = chunk
    pad = (-l) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    lc = x.shape[1]
    c = lc // Q
    xq = x.reshape(b, c, Q, h, p).float()
    Aq = dtA.reshape(b, c, Q, h).permute(0, 3, 1, 2).float()      # (b,h,c,Q)
    Bq = B.reshape(b, c, Q, n).float()
    Cq = C.reshape(b, c, Q, n).float()

    A_cumsum = torch.cumsum(Aq, dim=-1)                           # (b,h,c,Q)
    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(segsum(Aq))                                     # (b,h,c,Q,Q)
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cq, Bq, L, xq)
    # 2. per-chunk states
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)       # (b,h,c,Q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bq, decay_states, xq)
    # 3. the recurrence over chunk states S_c = exp(sumA_c) S_{c-1} + states_c
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                    device=x.device)
    chunk_decay = torch.exp(A_cumsum[..., -1]).permute(0, 2, 1)   # (b,c,h)
    s = initial_state.float()
    entering = []                                  # state entering chunk c
    for ci in range(c):
        entering.append(s)
        s = chunk_decay[:, ci, :, None, None] * s + states[:, ci]
    final_state = s
    prev = torch.stack(entering, dim=1)                           # (b,c,h,p,n)
    # 4. state -> output conversion
    state_decay_out = torch.exp(A_cumsum)                         # (b,h,c,Q)
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cq, prev, state_decay_out)
    Y = (Y_diag + Y_off).reshape(b, lc, h, p)
    return Y[:, :l], final_state


def ssd_step(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, state: torch.Tensor):
    """Single decode step.

    x: (b, h, p) raw input (not dt-scaled), dtA / dt: (b, h), B / C:
    (b, n), state: (b, h, p, n) f32.  Returns (y: (b, h, p) f32,
    new_state)."""
    dA = torch.exp(dtA.float())                                   # (b,h)
    upd = (dt.float()[..., None, None] * x.float()[..., :, None]
           * B.float()[:, None, None, :])                         # (b,h,p,n)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y, new_state


def _split_proj(z: torch.Tensor, cfg: SSMConfig, d_model: int):
    di = cfg.d_inner(d_model)
    n = cfg.d_state
    h = z.shape[-1] - 2 * di - 2 * n
    return torch.split(z, [di, di, n, n, h], dim=-1)   # zg, xin, B, C, dt


def _heads(params: dict, dt: torch.Tensor):
    """(softplus(dt + dt_bias), A = -exp(A_log)) in f32."""
    return (F.softplus(dt.float() + params["dt_bias"]),
            -torch.exp(params["A_log"].float()))


def ssd_block(params: dict, x: torch.Tensor, cfg: SSMConfig, d_model: int,
              state: dict | None = None):
    """Full Mamba-2 block over a sequence.  x: (B, T, d).

    state: {"ssm": (B, h, p, n) f32, "conv": (B, K-1, di+2n)} or None."""
    Bsz, T, _ = x.shape
    h, p, n = cfg.n_heads(d_model), cfg.head_dim, cfg.d_state
    di = cfg.d_inner(d_model)
    zg, xin, Bc, Cc, dt = _split_proj(x @ params["in_proj"], cfg, d_model)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    cache = state["conv"] if state is not None else None
    conv_out, new_conv = causal_conv1d(conv_in, params["conv_w"], cache)
    xin, Bc, Cc = torch.split(F.silu(conv_out), [di, n, n], dim=-1)
    dt, A = _heads(params, dt)                                    # (B,T,h), (h,)
    xh = xin.reshape(Bsz, T, h, p)
    x_dt = xh.float() * dt[..., None]
    h0 = state["ssm"] if state is not None else None
    y, final = ssd_chunked(x_dt, dt * A, Bc, Cc, cfg.chunk, h0)
    y = y + params["D"].float()[:, None] * xh.float()
    y = y.reshape(Bsz, T, di).to(x.dtype)
    y = rms_norm(y, params["norm"]) * F.silu(zg)
    return y @ params["out_proj"], {"ssm": final, "conv": new_conv}


def ssd_block_step(params: dict, x: torch.Tensor, cfg: SSMConfig, d_model: int,
                   state: dict):
    """Single-token decode.  x: (B, d).  Returns (y, new_state); the
    caller writes the new state into its cache."""
    Bsz = x.shape[0]
    h, p, n = cfg.n_heads(d_model), cfg.head_dim, cfg.d_state
    di = cfg.d_inner(d_model)
    zg, xin, Bc, Cc, dt = _split_proj(x @ params["in_proj"], cfg, d_model)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)                    # (B, di+2n)
    xc = torch.cat([state["conv"].to(conv_in.dtype), conv_in[:, None]], dim=1)
    conv_out = (xc.float() * params["conv_w"].float()[None]).sum(dim=1)
    xin, Bc, Cc = torch.split(F.silu(conv_out).to(x.dtype), [di, n, n], dim=-1)
    dt, A = _heads(params, dt)                                    # (B,h)
    xh = xin.reshape(Bsz, h, p)
    y, new_ssm = ssd_step(xh, dt * A, dt, Bc, Cc, state["ssm"])
    y = y + params["D"].float()[:, None] * xh.float()
    y = y.reshape(Bsz, di).to(x.dtype)
    y = rms_norm(y, params["norm"]) * F.silu(zg)
    return y @ params["out_proj"], {"ssm": new_ssm, "conv": xc[:, 1:]}
