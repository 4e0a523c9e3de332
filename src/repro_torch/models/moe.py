"""Mixture-of-experts FFN layer: routing, capacity dispatch, experts,
combine.

This is the plain (monolithic scatter/gather) formulation of the JAX
package's ``models/moe.py``.  ``route`` + ``dispatch_indices`` are also
the plain version of the fused ``kernels.gating_dispatch`` CUDA kernel.

Where torch differs from JAX, this module does it explicitly:
  * top-k ties go to the lowest expert index (``lax.top_k``); a stable
    descending sort gives that, ``torch.topk`` does not promise it;
  * JAX's ``mode="fill"`` gather and ``mode="drop"`` scatter become an
    extra zero row (gather) and an extra trash column (scatter);
  * the uint32 token hash is done in int64, masked to 32 bits;
  * the combine adds expert by expert in ascending order, so its sum
    order is fixed on the card too (see ``combine``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.models.common import activation
from repro_torch.models.ffn import gated_ffn

_U32 = 0xFFFFFFFF


class Routing(NamedTuple):
    """Routing decision for a flat batch of T tokens."""
    gates: torch.Tensor      # (T, K) combine weights (f32)
    experts: torch.Tensor    # (T, K) int32 expert ids
    probs: torch.Tensor      # (T, E) router probabilities (f32)


def topk_lowest_index(probs: torch.Tensor, k: int):
    """Top-k values and indices with ties broken toward the lowest
    index, as ``jax.lax.top_k`` does."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
          bias: Optional[torch.Tensor] = None) -> Routing:
    """Top-k softmax routing.  x: (T, d), w_router: (d, E), bias (E,)."""
    logits = x.float() @ w_router.float()
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = topk_lowest_index(probs, top_k)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return Routing(gates, experts.to(torch.int32), probs)


def routing_counts(routing: Routing, n_experts: int,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-expert routed-token counts, (E,) f32, optionally weighted
    per token (the engine's live-row mask)."""
    one_hot = F.one_hot(routing.experts.long(), n_experts).float()
    if weights is not None:
        one_hot = one_hot * weights.float()[:, None, None]
    return one_hot.sum(dim=(0, 1))


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h, c < 2**32, in int64 without overflow."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def token_hash01(tok_ids: torch.Tensor) -> torch.Tensor:
    """Deterministic hash of token index -> [0, 1) f32 (splitmix-style),
    bit-identical to the JAX package's uint32 ``_token_hash01``."""
    h = tok_ids.long() & _U32
    h = _mul_u32(h, 2654435761)
    h = h ^ (h >> 16)
    h = _mul_u32(h, 2246822519)
    h = h ^ (h >> 13)
    return h.float() * (2.0 ** -32)


def replica_assign(experts, rep_node, rep_slot, rep_cum, slots_per_node: int):
    """Map (T, K) expert ids to virtual expert slots under a replicated
    placement: the replica is chosen by the token-index hash against the
    replica's cumulative traffic fractions.  Returns (vslot, node)."""
    T = experts.shape[0]
    e = experts.long()
    u = token_hash01(torch.arange(T, device=experts.device))
    cum = rep_cum.float()[e]                                   # (T,K,R)
    r = (u[:, None, None] >= cum).sum(-1).clamp(max=rep_cum.shape[-1] - 1)
    node = rep_node.long()[e].gather(-1, r[..., None])[..., 0]
    slot = rep_slot.long()[e].gather(-1, r[..., None])[..., 0]
    return (node * slots_per_node + slot).to(torch.int32), node.to(torch.int32)


def load_balance_loss(routing: Routing, n_experts: int) -> torch.Tensor:
    """Switch-transformer auxiliary loss: E * sum_e f_e * p_e / K, where
    f_e is the share of the T tokens routed to e (summing to K over e)
    and p_e the mean router probability.  Its gradient reaches the
    router through ``probs`` only."""
    T, K = routing.experts.shape
    f = F.one_hot(routing.experts.long(), n_experts).float().sum(dim=(0, 1)) / T
    p = routing.probs.mean(dim=0)
    return n_experts * (f * p).sum() / K


def expert_capacity(n_tokens: int, cfg: MoEConfig, mode: str) -> int:
    """Static per-expert capacity.  'full' is drop-free (C = T)."""
    if mode == "full":
        return n_tokens
    cf = cfg.capacity_factor if mode == "train" else 2.0 * cfg.capacity_factor
    c = int(-(-n_tokens * cfg.top_k * cf // cfg.n_experts))
    c = max(4, -(-c // 4) * 4)  # multiple of 4, >= 4
    return min(c, n_tokens)


def dispatch_indices(routing: Routing, n_experts: int, capacity: int,
                     valid: Optional[torch.Tensor] = None):
    """Capacity-slot build in token-major first-come-first-served order.

    valid: optional (T, K) bool; False entries are dropped.  Returns
    (idx_buf (E, C) int32 with sentinel T = empty, gate_buf (E, C) f32).
    """
    T, K = routing.experts.shape
    e = routing.experts.long()
    mask = F.one_hot(e, n_experts).float()                     # (T,K,E)
    if valid is not None:
        mask = mask * valid[..., None].float()
    flat = mask.reshape(T * K, n_experts)
    pos_flat = torch.cumsum(flat, dim=0) - flat
    pos = (pos_flat.reshape(T, K, n_experts) * mask).sum(-1).long()
    keep = pos < capacity
    if valid is not None:
        keep = keep & valid
    # dropped entries go to a trash column past the capacity
    slot = torch.where(keep, pos, capacity)
    tok = torch.arange(T, device=e.device, dtype=torch.int32)[:, None].expand(T, K)
    idx_buf = torch.full((n_experts, capacity + 1), T, dtype=torch.int32,
                         device=e.device)
    idx_buf[e.reshape(-1), slot.reshape(-1)] = tok.reshape(-1)
    gate_buf = torch.zeros((n_experts, capacity + 1), dtype=torch.float32,
                           device=e.device)
    gate_buf[e.reshape(-1), slot.reshape(-1)] = routing.gates.reshape(-1).float()
    return idx_buf[:, :capacity].contiguous(), gate_buf[:, :capacity].contiguous()


def gather_tokens(x: torch.Tensor, idx_buf: torch.Tensor) -> torch.Tensor:
    """(T, d) tokens -> (E, C, d) expert buffers; sentinel T reads zeros."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    return pad[idx_buf.long()]


def combine(out: torch.Tensor, idx_buf: torch.Tensor, gate_buf: torch.Tensor,
            n_tokens: int) -> torch.Tensor:
    """Gate-weighted scatter-add of (E, C, d) expert outputs back to
    (T, d) f32.  One ``index_add_`` per expert, in ascending expert
    order: inside one call every real token index appears at most once,
    so even the card's atomic adds never race on a token row and the
    sum order is fixed.  Sentinel slots land in a trash row."""
    E, _, d = out.shape
    y = out.new_zeros((n_tokens + 1, d), dtype=torch.float32)
    w = out.float() * gate_buf[..., None]
    for e in range(E):
        y.index_add_(0, idx_buf[e].long(), w[e])
    return y[:n_tokens]


_ROUTED_IMPL = None


def set_routed_impl(fn):
    """Install fn(params, x, cfg, act, capacity_mode) -> y (T, d) as the
    routed-expert computation of every ``moe_ffn`` (``core.m2n.use_m2n``
    installs the M2N dispatch), or None for ``routed_experts_dense``.
    Returns the previous one."""
    global _ROUTED_IMPL
    prev = _ROUTED_IMPL
    _ROUTED_IMPL = fn
    return prev


def routed_experts_dense(params: dict, x: torch.Tensor, cfg: MoEConfig,
                         act: str, capacity_mode: str, with_aux: bool = False):
    """Plain routed-expert computation (monolithic scatter/gather):
    (y (T, d), aux), aux the load-balance loss of the same routing with
    ``with_aux``, else None."""
    T = x.shape[0]
    routing = route(x, params["router"], cfg.top_k, params.get("router_bias"))
    aux = load_balance_loss(routing, cfg.n_experts) if with_aux else None
    C = expert_capacity(T, cfg, capacity_mode)
    idx_buf, gate_buf = dispatch_indices(routing, cfg.n_experts, C)
    xe = gather_tokens(x, idx_buf)
    h = activation(torch.einsum("ecd,edf->ecf", xe, params["we1"]), act)
    h = h * torch.einsum("ecd,edf->ecf", xe, params["we3"])
    out = torch.einsum("ecf,efd->ecd", h, params["we2"])
    return combine(out, idx_buf, gate_buf, T).to(x.dtype), aux


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
            capacity_mode: str = "train", with_aux: bool = False):
    """MoE FFN over a flat token batch x: (T, d) -> (y (T, d), aux), as
    the JAX function.  Includes the always-on shared experts and the
    dense residual where configured.

    aux is the load-balance loss with ``with_aux`` (training), else
    None: the serving paths leave it off, so a decode step issues none
    of its ops.  An installed routed impl (m2n, a serving path) computes
    no aux: it is 0 there, as under the JAX package's m2n path."""
    if _ROUTED_IMPL is not None:
        y = _ROUTED_IMPL(params, x, cfg, act, capacity_mode)
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
    else:
        y, aux = routed_experts_dense(params, x, cfg, act, capacity_mode, with_aux)
    return add_dense_extras(params, x, y, act), aux


def add_dense_extras(params: dict, h: torch.Tensor, y: torch.Tensor,
                     act: str) -> torch.Tensor:
    """Add the shared experts (qwen2-moe) and the dense residual
    (arctic) to the routed output y: the batch-dense part of an MoE FFN,
    which stays on the attention side."""
    if "ws1" in params:
        shared = gated_ffn(h, params["ws1"], params["ws3"], params["ws2"], act)
        g = torch.sigmoid(h.float() @ params["shared_gate"].float())
        y = y + (g[:, None] * shared.float()).to(h.dtype)
    if "wd1" in params:
        y = y + gated_ffn(h, params["wd1"], params["wd3"], params["wd2"], act)
    return y
