"""M2N token dispatch (paper §5) on one card.

The JAX package runs the routed experts of a MoE layer in a
``shard_map`` over an expert axis: every expert shard routes the tokens
it holds (replicated across the axis), gathers only the tokens routed
to the experts it owns, runs their complete MLPs, and adds its
gate-weighted partial output into one ``psum`` over the axis (the
combine, the only wire traffic).

On one card the expert axis is ``n_shards`` expert shards run one after
the other.  Shard j does what the JAX kernel branch does (``local_fn``
with ``use_kernels``):

  1. ``kops.gating_dispatch(..., owner=j, slots_per_node=e_loc)``: the
     fused router -> top-k -> dispatch, keeping only shard j's entries
     (with the placement tables, the replica the token hash picks);
  2. ``gather_tokens`` of those entries into (e_loc, C, d) buffers;
  3. ``kops.grouped_mlp`` over shard j's experts, the rows of dropped or
     empty slots masked to zeros;
  4. the gate-weighted combine of its partial (T, d) output.

The ``psum`` becomes the sum of the shards' partials in shard order
0..N-1.  Install it around any forward with ``use_m2n(n_shards)``;
every ``moe_ffn`` then routes through it.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.config import MoEConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import moe as moe_lib


def sharded_routed_experts(params: dict, x: torch.Tensor, cfg: MoEConfig,
                           act: str, capacity_mode: str, *, n_shards: int,
                           weights_2d: bool = False,
                           tables: Optional[dict] = None,
                           with_counts: bool = False,
                           count_weights: Optional[torch.Tensor] = None,
                           transport=None):
    """M2N routed-experts computation over ``n_shards`` expert shards.

    x: (T, d).  Returns y (T, d) in x's dtype, or (y, counts) with
    ``with_counts``: the (E,) per-expert routed-token counts weighted by
    ``count_weights`` (T,), the live traffic trace of the serving
    engine's load balancer.  Every shard routes the same tokens, so the
    counts are shard 0's (the JAX package returns the replicated value
    once).  The JAX package also returns the load-balance loss; its
    kernel path pins it to 0 and no decode path reads it, so it is left
    out here.

    Without ``tables`` the E experts are padded to N * e_loc buckets
    (e_loc = ceil(E / N)) and shard j owns buckets [j e_loc, (j+1)
    e_loc).  A bucket past E is never routed to, so a shard's MLP runs
    over its real experts only: views of ``params["we*"]``, no padded
    copy.  With ``tables`` (``rep_node``/``rep_slot``/``rep_cum`` (E, R)
    tensors and int ``slots_per_node`` S, as ``core.load_balance``'s
    ``PlacementTables``), ``params["we*"]`` are the (N*S, ...)
    virtual-slot weights and shard j takes the view of slots [j S,
    (j+1) S).

    transport: the combine's wire bytes (``m2n_traffic_bytes``) go on it
    as one ``collective`` hop."""
    if weights_2d:
        raise NotImplementedError(
            "weights_2d shards d_ff over a data axis, which the one-card "
            "m2n dispatch has not got (the JAX kernel path refuses it too)")
    E = cfg.n_experts
    T, d = x.shape
    w1, w3, w2 = params["we1"], params["we3"], params["we2"]
    tk = {}
    if tables is not None:
        e_loc = int(tables["slots_per_node"])
        if w1.shape[0] != n_shards * e_loc:
            raise ValueError(f"placed expert weights must be gathered to "
                             f"(N*S={n_shards * e_loc}, ...), got "
                             f"{tuple(w1.shape)}")
        tk = {k: tables[k] for k in ("rep_node", "rep_slot", "rep_cum")}
        n_real = n_shards * e_loc
    else:
        e_loc = -(-E // n_shards)
        n_real = E
    cap = moe_lib.expert_capacity(T, cfg, capacity_mode)
    y, counts = None, None
    for j in range(n_shards):
        idx_buf, gate_buf, c = kops.gating_dispatch(
            x, params["router"], cfg.top_k, n_buckets=n_shards * e_loc,
            capacity=cap, bias=params.get("router_bias"),
            count_weights=count_weights, owner=j, slots_per_node=e_loc, **tk)
        if counts is None:
            counts = c
        lo, hi = j * e_loc, min(n_real, (j + 1) * e_loc)
        if hi <= lo:            # only padded buckets: nothing routed here
            part = x.new_zeros((T, d), dtype=torch.float32)
        else:
            idx, gates = idx_buf[:hi - lo], gate_buf[:hi - lo]
            xe = moe_lib.gather_tokens(x, idx)
            out = kops.grouped_mlp(xe, w1[lo:hi], w3[lo:hi], w2[lo:hi], act,
                                   row_valid=idx < T)
            part = moe_lib.combine(out, idx, gates, T)
        y = part if y is None else y + part      # the psum, in shard order
    if transport is not None and n_shards > 1:
        transport.record_collective(
            m2n_traffic_bytes(T, d, cfg.top_k, E, n_shards,
                              x.element_size())["m2n"], fanout=n_shards)
    y = y.to(x.dtype)
    return (y, counts) if with_counts else y


@contextlib.contextmanager
def use_m2n(n_shards: int, *, weights_2d: bool = False, transport=None):
    """Route every ``moe_ffn`` through the M2N dispatch over ``n_shards``
    expert shards within the block; ``transport`` accounts each
    dispatch's combine bytes."""

    def impl(params, x, cfg, act, capacity_mode):
        return sharded_routed_experts(params, x, cfg, act, capacity_mode,
                                      n_shards=n_shards,
                                      weights_2d=weights_2d,
                                      transport=transport)

    prev = moe_lib.set_routed_impl(impl)
    try:
        yield
    finally:
        moe_lib.set_routed_impl(prev)


def m2n_traffic_bytes(t_local: int, d_model: int, top_k: int,
                      n_experts: int, n_expert_shards: int,
                      bytes_per_el: int = 2) -> dict:
    """Analytic wire traffic per MoE layer of three dispatch schemes: the
    baseline (all-gather everything), classic EP all-to-all, and the M2N
    combine-only scheme above (a reduce-scatter plus an all-gather)."""
    allgather = t_local * d_model * (n_expert_shards - 1) * bytes_per_el * 2
    a2a = 2 * t_local * top_k * d_model * bytes_per_el * (
        (n_expert_shards - 1) / n_expert_shards)
    m2n = t_local * d_model * bytes_per_el * (
        (n_expert_shards - 1) / n_expert_shards) * 2
    return {"baseline_allgather": allgather, "ep_all2all": a2a, "m2n": m2n}
