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
from repro_torch.models import parallel
from repro_torch.models.common import activation
from repro_torch.models.ffn import gated_ffn
from repro_torch.trace import span

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


def slot_positions(e: torch.Tensor, n_experts: int,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, K) int64: each entry's position among the entries routed to
    its expert (``e``: (T, K) int64 expert ids), in token-major order
    (False ``valid`` entries take no position)."""
    T, K = e.shape
    mask = F.one_hot(e, n_experts).float()                     # (T,K,E)
    if valid is not None:
        mask = mask * valid[..., None].float()
    flat = mask.reshape(T * K, n_experts)
    pos_flat = torch.cumsum(flat, dim=0) - flat
    return (pos_flat.reshape(T, K, n_experts) * mask).sum(-1).long()


def fill_buffers(e: torch.Tensor, gates: torch.Tensor, n_experts: int,
                 capacity: int, keep: torch.Tensor, slot: torch.Tensor):
    """(idx_buf (E, C) int32 with sentinel T = empty, gate_buf (E, C)
    f32) with each kept (T, K) entry (``e`` int64 expert ids, ``gates``
    their weights) at its expert's ``slot``."""
    T, K = e.shape
    # dropped entries go to a trash column past the capacity
    slot = torch.where(keep, slot, capacity)
    tok = torch.arange(T, device=e.device, dtype=torch.int32)[:, None].expand(T, K)
    idx_buf = torch.full((n_experts, capacity + 1), T, dtype=torch.int32,
                         device=e.device)
    idx_buf[e.reshape(-1), slot.reshape(-1)] = tok.reshape(-1)
    gate_buf = torch.zeros((n_experts, capacity + 1), dtype=torch.float32,
                           device=e.device)
    gate_buf[e.reshape(-1), slot.reshape(-1)] = gates.reshape(-1).float()
    return idx_buf[:, :capacity].contiguous(), gate_buf[:, :capacity].contiguous()


def dispatch_indices(routing: Routing, n_experts: int, capacity: int,
                     valid: Optional[torch.Tensor] = None):
    """Capacity-slot build in token-major first-come-first-served order.

    valid: optional (T, K) bool; False entries are dropped.  Returns
    (idx_buf (E, C) int32 with sentinel T = empty, gate_buf (E, C) f32).
    """
    e = routing.experts.long()
    pos = slot_positions(e, n_experts, valid)
    keep = pos < capacity
    if valid is not None:
        keep = keep & valid
    return fill_buffers(e, routing.gates, n_experts, capacity, keep, pos)


def gather_tokens(x: torch.Tensor, idx_buf: torch.Tensor) -> torch.Tensor:
    """(T, d) tokens -> (E, C, d) expert buffers; sentinel T reads zeros."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    return pad[idx_buf.long()]


# experts a ``model.moe.combine`` span covers: ~11 host events each, so a
# span stays short enough that a profiler's idle gap inside it is named
# by it (the benchmark looks back 400 host events for the open range)
COMBINE_SPAN_EXPERTS = 16


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
    for e0 in range(0, E, COMBINE_SPAN_EXPERTS):
        with span("model.moe.combine"):
            for e in range(e0, min(E, e0 + COMBINE_SPAN_EXPERTS)):
                y.index_add_(0, idx_buf[e].long(), w[e])
    return y[:n_tokens]


_ROUTED_IMPL = None


def set_routed_impl(fn):
    """Install fn(params, x, cfg, act, capacity_mode, with_aux) -> (y (T,
    d), aux or None) as the routed-expert computation of every
    ``moe_ffn`` (``core.m2n.use_m2n`` installs the M2N dispatch,
    ``training.data_parallel`` the data-parallel one), or None for
    ``routed_experts_dense``.  Returns the previous one."""
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
    return experts_combine(params, x, idx_buf, gate_buf, act, cfg), aux


def _expert_mlp_combine(params, x, idx_buf, gate_buf, act) -> torch.Tensor:
    xe = gather_tokens(x, idx_buf)
    h = activation(torch.einsum("ecd,edf->ecf", xe, params["we1"]), act)
    h = h * torch.einsum("ecd,edf->ecf", xe, params["we3"])
    out = torch.einsum("ecf,efd->ecd", h, params["we2"])
    return combine(out, idx_buf, gate_buf, x.shape[0])


def experts_combine(params: dict, x: torch.Tensor, idx_buf: torch.Tensor,
                    gate_buf: torch.Tensor, act: str,
                    cfg: Optional[MoEConfig] = None) -> torch.Tensor:
    """The plain expert MLP over (E, C) dispatch buffers of x's rows and
    the gate-weighted combine back to (T, d) in x's dtype.

    Under an installed model axis (``models.parallel``; ``cfg`` gives the
    full sizes) where this rank holds E / m experts (EP) or every
    expert's block of d_ff (where E does not divide), the rank runs its
    experts' buffers or its d_ff block; x and the gates enter the rank's
    region (the gates' gradient is then the whole one on every rank) and
    the f32 partial combines are summed over the axis.  Inside a
    sequence-parallel region the output is the rank's block of the
    sequence (``ModelParallel.reduce_act``, ``parallel.seq_block``)."""
    mp = parallel.current() if cfg is not None else None
    if mp is not None:
        ex = mp.block(cfg.n_experts, params["we1"].shape[0])
        ff = mp.block(cfg.d_ff_expert, params["we1"].shape[2])
        if ex is not None or ff is not None:
            # the whole (replicated) gates enter, then the rank takes its rows
            xm, gate_buf = mp.enter_seq(x), mp.enter(gate_buf)
            if ex is not None:
                idx_buf, gate_buf = idx_buf[ex], gate_buf[ex]
            y = _expert_mlp_combine(params, xm, idx_buf, gate_buf, act)
            return mp.reduce_act(y).to(x.dtype)
    y = _expert_mlp_combine(params, x, idx_buf, gate_buf, act)
    return parallel.seq_block(y).to(x.dtype)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
            capacity_mode: str = "train", with_aux: bool = False):
    """MoE FFN over a flat token batch x: (T, d) -> (y (T, d), aux), as
    the JAX function.  Includes the always-on shared experts and the
    dense residual where configured.

    aux is the load-balance loss with ``with_aux`` (training), else
    None: the serving paths leave it off, so a decode step issues none
    of its ops.  An installed routed impl gives its own aux (0 on the
    m2n kernel path, as under the JAX package's)."""
    impl = _ROUTED_IMPL if _ROUTED_IMPL is not None else routed_experts_dense
    y, aux = impl(params, x, cfg, act, capacity_mode, with_aux)
    return add_dense_extras(params, x, y, act, cfg), aux


def add_dense_extras(params: dict, h: torch.Tensor, y: torch.Tensor,
                     act: str, cfg: Optional[MoEConfig] = None) -> torch.Tensor:
    """Add the shared experts (qwen2-moe) and the dense residual
    (arctic) to the routed output y: the batch-dense part of an MoE FFN,
    which stays on the attention side.  ``cfg`` gives their full widths
    to an installed model axis (``ffn.gated_ffn``)."""
    if "ws1" in params:
        shared = gated_ffn(h, params["ws1"], params["ws3"], params["ws2"], act,
                           cfg.d_ff_shared if cfg is not None else None)
        g = torch.sigmoid(h.float() @ params["shared_gate"].float())
        y = y + (parallel.seq_block(g)[:, None] * shared.float()).to(h.dtype)
    if "wd1" in params:
        y = y + gated_ffn(h, params["wd1"], params["wd3"], params["wd2"], act,
                          cfg.d_ff_dense_residual if cfg is not None else None)
    return y
