"""Data-parallel training: the MoE dispatch of the JAX step's global
batch, with each rank holding its own rows.

Under ``jit`` with the batch sharded over a "data" axis, the JAX train
step computes ``routed_experts_dense`` over the global T tokens: the
capacity is ``expert_capacity(T_global)``, the slot positions come from
one cumsum over the global (T * K) entries in token-major order, and the
load-balance loss from the global f and p.  Rank r of R holds the
contiguous rows [r T/R, (r+1) T/R), so an entry's global position is its
position among the rank's entries plus the entries that ranks before r
routed to the same expert, kept or dropped.  ``DataParallelMoE`` gathers
those per-expert counts with one ``all_reduce`` of an (R, E) buffer in
which each rank fills its row (gloo has no CUDA ``all_gather``), keeps
an entry when its global position is below C_global, and runs the
(row-wise) expert MLP on the rank's own tokens only.

The aux is a local term whose mean over the ranks is the global loss,
value and gradient: with f the global routed shares (from the reduced
counts, no gradient) and p_r the mean router probability over rank r's
rows, ``E / K * sum_e f_e p_e = mean_r (E / K * sum_e f_e p_{r,e})``,
because the ranks hold equal row counts, so p is the mean of the p_r.
The data-parallel step averages the gradients over the ranks, so the
local term gives exactly the global gradient, and it reports the
all-reduced mean.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.launch.mesh import RecordedGroup
from repro_torch.models import moe as moe_lib


def group_size(group) -> int:
    """The ranks of ``group``; None is one rank (this one).  A group is a
    ``torch.distributed`` process group or a
    ``launch.mesh.RecordedGroup`` (the dry run's stand-in)."""
    if group is None:
        return 1
    return group.size() if isinstance(group, RecordedGroup) else \
        dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None:
        return 0
    return group.rank() if isinstance(group, RecordedGroup) else dist.get_rank(group)


def group_all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``; returns ``t``."""
    if isinstance(group, RecordedGroup):
        return group.all_reduce(t)
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def local_rows(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous rows of a global batch ``t`` (B, ...), B a
    multiple of the group's size."""
    if group is None:
        return t
    b = t.shape[0] // group_size(group)
    r = group_rank(group)
    return t[r * b:(r + 1) * b]


def average_grads(grads, group) -> None:
    """Each gradient, summed over the group and divided by its size, in
    place (one ``all_reduce`` per leaf)."""
    if group is None:
        return
    n = group_size(group)
    for g in grads:
        group_all_reduce(g, group)
        g.div_(n)


@torch.no_grad()
def check_replicated(tensors, group, what: str) -> None:
    """Raise unless every rank of the group holds the same ``tensors``:
    an ``all_reduce`` of per-tensor checksums (sum and sum of squares in
    f64), max against min.  A group of None is this rank alone."""
    if group is None:
        return
    sums = torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                        for t in tensors]).reshape(-1)
    both = torch.cat([sums, -sums])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, lo = both[:sums.numel()], -both[sums.numel():]
    off = (hi != lo).reshape(-1, 2).any(-1).nonzero().reshape(-1).tolist()
    if off:
        raise RuntimeError(f"{what} differ across ranks (tensors {off})")


class DataParallelMoE:
    """The routed experts of the JAX step's global batch on this rank's
    rows (see the module docstring); ``group`` None is one data rank.  ``dropped`` accumulates the global
    count of entries past their expert's capacity (a 0-d tensor, read it
    on the host when wanted) while ``count_drops`` is true; the train
    step clears it before backward, whose remat recompute dispatches
    again."""

    def __init__(self, group):
        self.group = group
        self.size = group_size(group)
        self.rank = group_rank(group)
        self.dropped = torch.zeros(())
        self.count_drops = True

    def __call__(self, params: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
                 capacity_mode: str, with_aux: bool = False):
        T_loc, E = x.shape[0], cfg.n_experts
        T = T_loc * self.size
        routing = moe_lib.route(x, params["router"], cfg.top_k,
                                params.get("router_bias"))
        e = routing.experts.long()
        rows = x.new_zeros((self.size, E), dtype=torch.float32)
        rows[self.rank] = F.one_hot(e, E).float().sum(dim=(0, 1))
        group_all_reduce(rows, self.group)
        prefix, total = rows[:self.rank].sum(0), rows.sum(0)
        C = moe_lib.expert_capacity(T, cfg, capacity_mode)
        pos = moe_lib.slot_positions(e, E)
        keep = pos + prefix.long()[e] < C
        # an expert takes at most T_loc of this rank's rows
        idx_buf, gate_buf = moe_lib.fill_buffers(e, routing.gates, E,
                                                 min(C, T_loc), keep, pos)
        y = moe_lib.experts_combine(params, x, idx_buf, gate_buf, act, cfg)
        if self.count_drops:
            self.dropped = (self.dropped.to(x.device)
                            + (total - C).clamp(min=0).sum())
        aux = None
        if with_aux:
            f = total / T
            aux = E * (f * routing.probs.mean(dim=0)).sum() / cfg.top_k
        return y, aux

    @contextlib.contextmanager
    def install(self):
        """Route every ``moe_ffn`` through this dispatch within the block."""
        prev = moe_lib.set_routed_impl(self)
        try:
            yield self
        finally:
            moe_lib.set_routed_impl(prev)
