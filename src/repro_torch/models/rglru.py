"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427),
the JAX package's ``models/rglru.py`` in PyTorch.

The block is: x -> {recurrent branch, gate branch}; the recurrent branch
goes through a short causal depthwise conv then the RG-LRU linear
recurrence; output = W_out (GeLU(gate) * h).

The RG-LRU recurrence per channel:
    r_t = sigmoid(W_a u_t + b_a)
    i_t = sigmoid(W_x u_t + b_x)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

W_a / W_x are dense matrices, as in the JAX package (the published model
uses block-diagonal ones).

Sequence mode runs the recurrence as a loop over the time axis, one
``h = a_t * h + b_t`` per step in f32.  The JAX package runs it as an
``associative_scan`` (a log-depth tree): the same products and sums in
another order, so the two agree to f32 rounding, not bit for bit.

Under a model axis (``models.parallel``) that splits the width W, a
rank holds its channels of every leaf and state (``w_in_x``,
``w_in_gate``, ``conv_w`` and ``w_a`` / ``w_x`` by column, ``b_a``,
``b_x``, ``lam``, ``w_out``'s rows, the cache's ``h`` and ``conv``): the
depthwise conv and the recurrence run on its channels alone, but its
gates read every channel of the conv output, gathered once per layer
and step (``enter_gather``), and ``w_out``'s partial products are
summed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import RGLRUConfig
from repro_torch.models import parallel


def linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                      h0: torch.Tensor | None = None):
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a, b: (B, T, W) f32.

    Returns (h: (B, T, W), h_last: (B, W))."""
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0.to(b.dtype)
    out = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    # stacked, not written into a buffer step by step: autograd then
    # keeps one node per step instead of copying the buffer's gradient
    return torch.stack(out, dim=1), h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, T, W), w: (K, W).

    cache: (B, K-1, W) previous inputs (decode / prefill continuation).
    Returns (y: (B, T, W) in x's dtype, new_cache: (B, K-1, W))."""
    K = w.shape[0]
    B, T, W = x.shape
    if cache is None:
        cache = x.new_zeros((B, K - 1, W))
    xc = torch.cat([cache.to(x.dtype), x], dim=1)          # (B, T+K-1, W)
    y = torch.zeros((B, T, W), dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + xc[:, j:j + T].float() * w[j].float()
    return y.to(x.dtype), xc[:, -(K - 1):]


def _gates(uf: torch.Tensor, params: dict, cfg: RGLRUConfig,
           u_all: torch.Tensor | None = None):
    """(a, sqrt(1 - a^2) * i) of the recurrence for f32 inputs ``uf``.
    ``u_all``: every channel of u where ``uf`` holds a rank's block (the
    gate matrices' rows span the whole width)."""
    ua = uf if u_all is None else u_all.float()
    r = torch.sigmoid(ua @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(ua @ params["w_x"].float() + params["b_x"])
    log_a = -cfg.c * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, gated


def rglru_scan(u: torch.Tensor, params: dict, cfg: RGLRUConfig,
               h0: torch.Tensor | None = None, u_all: torch.Tensor | None = None):
    """RG-LRU over a sequence.  u: (B, T, W) (a rank's channels, with
    ``u_all`` every channel).  Returns (h, h_last f32)."""
    a, gated = _gates(u.float(), params, cfg, u_all)
    h, h_last = linear_recurrence(a, gated, h0)
    return h.to(u.dtype), h_last


def rglru_step(u: torch.Tensor, params: dict, cfg: RGLRUConfig,
               h: torch.Tensor, u_all: torch.Tensor | None = None):
    """Single decode step.  u: (B, W), h: (B, W) f32 state."""
    a, gated = _gates(u.float(), params, cfg, u_all)
    h_new = a * h + gated
    return h_new.to(u.dtype), h_new


def _model_axis(params: dict, cfg: RGLRUConfig):
    """The installed model axis where it splits the width (every leaf and
    state of the block splits with it), else None."""
    mp = parallel.current()
    if mp is None or mp.block(cfg.lru_width, params["w_in_x"].shape[1]) is None:
        return None
    return mp


def rglru_block(params: dict, x: torch.Tensor, cfg: RGLRUConfig, act_gelu,
                state: dict | None = None):
    """Full Griffin recurrent block over a sequence.

    x: (B, T, d).  state: {"h": (B, W) f32, "conv": (B, K-1, W)} or None.
    Returns (y: (B, T, d), new_state): under a model axis that splits W
    the state holds the rank's channels."""
    mp = _model_axis(params, cfg)
    if mp is not None:
        x = mp.enter_seq(x)
    u = x @ params["w_in_x"]                 # (B, T, W) recurrent branch
    g = x @ params["w_in_gate"]              # (B, T, W) gate branch
    cache = state["conv"] if state is not None else None
    h0 = state["h"] if state is not None else None
    u, new_conv = causal_conv1d(u, params["conv_w"], cache)
    u_all = mp.enter_gather(u, -1) if mp is not None else None
    h, h_last = rglru_scan(u, params, cfg, h0, u_all)
    y = (act_gelu(g) * h) @ params["w_out"]
    y = parallel.seq_block(y) if mp is None else mp.reduce_act(y)
    return y, {"h": h_last, "conv": new_conv}


def rglru_block_step(params: dict, x: torch.Tensor, cfg: RGLRUConfig, act_gelu,
                     state: dict):
    """Single-token decode.  x: (B, d).  Returns (y, new_state); the
    caller writes the new state into its cache (as ``rglru_block``, the
    rank's channels under a model axis that splits W)."""
    mp = _model_axis(params, cfg)
    u = x @ params["w_in_x"]                 # (B, W)
    g = x @ params["w_in_gate"]
    xc = torch.cat([state["conv"].to(u.dtype), u[:, None]], dim=1)  # (B, K, W)
    uc = (xc.float() * params["conv_w"].float()[None]).sum(dim=1).to(x.dtype)
    u_all = mp.gather(uc, -1) if mp is not None else None
    h_out, h_new = rglru_step(uc, params, cfg, state["h"], u_all)
    y = (act_gelu(g) * h_out) @ params["w_out"]
    if mp is not None:
        y = mp.reduce(y)
    return y, {"h": h_new, "conv": xc[:, 1:]}
