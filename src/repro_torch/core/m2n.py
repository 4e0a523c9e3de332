"""M2N token dispatch (paper §5): expert shards in one process, or one
shard per process.

The JAX package runs the routed experts of a MoE layer in a
``shard_map`` over an expert axis: every expert shard routes the tokens
it holds (replicated across the axis), gathers only the tokens routed
to the experts it owns, runs their complete MLPs, and adds its
gate-weighted partial output into one ``psum`` over the axis (the
combine, the only wire traffic).

Shard j does what the JAX kernel branch does (``local_fn`` with
``use_kernels``):

  1. ``kops.gating_dispatch(..., owner=j, slots_per_node=e_loc)``: the
     fused router -> top-k -> dispatch, keeping only shard j's entries
     (with the placement tables, the replica the token hash picks);
  2. ``gather_tokens`` of those entries into (e_loc, C, d) buffers;
  3. ``kops.grouped_mlp`` over shard j's experts, the rows of dropped or
     empty slots masked to zeros;
  4. the gate-weighted combine of its partial (T, d) output, in f32.

Without a grid (``mesh=None``) the ``n_shards`` shards run one after
the other in this process, and the ``psum`` is the sum of their partials
in shard order 0..N-1.  With a ``launch.mesh.ProcessMesh``, rank j of the
expert axis runs shard j only and the ``psum`` is an ``all_reduce`` over
the expert axis's group.  A data axis follows the JAX package's two
rules:

  * without ``weights_2d`` every data rank holds its own rows of x, and
    routing and capacity come from those rows; the counts are summed
    over the data axes (their ``psum``);
  * with ``weights_2d`` each expert's d_ff is split over the data axes:
    the rows are gathered over them (``ProcessMesh.all_gather``), every
    data rank routes all of them, runs its d_ff slice of the MLP, the
    f-partials are summed over the data axes, and each rank's rows of
    the combine are summed over the expert axis.  As in JAX this
    refuses the kernels and the placement tables, so it runs the JAX
    package's plain branch (``moe.route``,
    ``dispatch_indices(valid=local)``, three einsums) and has its
    load-balance loss, averaged over the data axes.

Under autograd (a train step: grad enabled and x or the weights
requiring grad) the plain branch runs without ``weights_2d`` too (JAX's
``use_kernels=False``; the kernels have no backward), every collective
an autograd function of ``models.parallel``; the serving paths run
under ``no_grad`` and keep the kernel branch and its in-place
``all_reduce``.

Install it around any forward with ``use_m2n``; every ``moe_ffn`` then
routes through it.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from repro_torch.config import MoEConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import moe as moe_lib
from repro_torch.models import parallel
from repro_torch.models.common import activation


def _shard(params, w, x, cfg, act, cap, j, n_shards, e_loc, n_real, tk,
           count_weights):
    """Shard j's kernel path: (partial (T, d) f32, counts (E,)).  ``w``:
    the (we1, we3, we2) of shard j's real experts (or slots)."""
    T, d = x.shape
    idx_buf, gate_buf, counts = kops.gating_dispatch(
        x, params["router"], cfg.top_k, n_buckets=n_shards * e_loc,
        capacity=cap, bias=params.get("router_bias"),
        count_weights=count_weights, owner=j, slots_per_node=e_loc, **tk)
    if n_real == 0:             # only padded buckets: nothing routed here
        return x.new_zeros((T, d), dtype=torch.float32), counts
    idx, gates = idx_buf[:n_real], gate_buf[:n_real]
    xe = moe_lib.gather_tokens(x, idx)
    out = kops.grouped_mlp(xe, *w, act, row_valid=idx < T)
    return moe_lib.combine(out, idx, gates, T), counts


def _shard_plain(params, w, x_all, cfg, act, cap, j, e_loc, n_real, cw, mesh,
                 expert_axis, f_axes=()):
    """Shard j's plain branch (the JAX package's ``use_kernels=False``
    ``local_fn``): (partial (T, d) f32 over the rows of ``x_all``, aux,
    counts).  ``f_axes``: the data axes over which ``w`` holds a block of
    d_ff (``weights_2d``), whose f-partials are summed over them.  Under
    autograd the rows and the (T, K) gates enter the shard's region over
    the expert axis (its experts' share of their gradient, summed over
    the shards where the rows and picks are alike; the shards' dispatch
    buffers hold different experts) and the f-partials' sum is
    differentiated as every data rank's loss summed."""
    E = cfg.n_experts
    T, d = x_all.shape
    routing = moe_lib.route(x_all, params["router"], cfg.top_k,
                            params.get("router_bias"))
    aux = moe_lib.load_balance_loss(routing, E)
    counts = moe_lib.routing_counts(routing, E, cw)
    local = routing.experts // e_loc == j
    local_ids = torch.where(local, routing.experts - j * e_loc, 0)
    gates = routing.gates
    grad = torch.is_grad_enabled() and (x_all.requires_grad or w[0].requires_grad)
    if grad:                    # the (T, ...) rows and picks, alike on every shard
        x_all = _enter_rows(x_all, mesh, expert_axis)
        gates = parallel.enter_over(gates, mesh, expert_axis)
    idx_buf, gate_buf = moe_lib.dispatch_indices(
        moe_lib.Routing(gates, local_ids, routing.probs), e_loc, cap, valid=local)
    if n_real == 0:             # every data rank of this shard skips alike
        zero = x_all.new_zeros((T, d), dtype=torch.float32)
        if grad:                # its backward meets the other shards' sums
            zero = zero + 0 * (x_all.float().sum() + gates.sum())
        return zero, aux, counts
    idx, gates = idx_buf[:n_real], gate_buf[:n_real]
    xe = moe_lib.gather_tokens(x_all, idx)
    w1, w3, w2 = w
    h = activation(torch.einsum("ecd,edf->ecf", xe, w1), act)
    h = h * torch.einsum("ecd,edf->ecf", xe, w3)
    out = torch.einsum("ecf,efd->ecd", h, w2)
    if f_axes:
        out = parallel.sum_data(out, mesh, f_axes) if grad else \
            mesh.all_reduce(out, f_axes)
    return moe_lib.combine(out, idx, gates, T), aux, counts


def _rows_over(mesh, dtuple, t: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``t``, in data-rank order (an all-gather
    over the data axes; its backward reduce-scatters the gradient)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return parallel.gather_data(t, mesh, dtuple, 0)
    return mesh.all_gather(t, dtuple, 0)


def _in_seq_region(mesh, axis) -> bool:
    """Whether the installed model axis is ``axis`` of ``mesh`` inside a
    sequence-parallel region (the rows are then its gathered sequence)."""
    mp = parallel.current()
    return mp is not None and mp.sp is not None and mp.mesh is mesh and axis == "model"


def _enter_rows(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The rows entering a shard's region over the expert axis
    (``ModelParallel.enter_seq`` inside a sequence-parallel region)."""
    if _in_seq_region(mesh, axis):
        return parallel.current().enter_seq(x)
    return parallel.enter_over(x, mesh, axis)


def _expert_sum(y: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The combine's sum over the expert axis: inside a sequence-parallel
    region of the installed model axis its reduce-scatter over the
    sequence (``ModelParallel.reduce_act``); under autograd a sum forward
    and identity backward (the shards share one loss); else in place."""
    if _in_seq_region(mesh, axis):
        return parallel.current().reduce_act(y)
    if torch.is_grad_enabled() and y.requires_grad:
        return parallel.reduce_over(y, mesh, axis)
    return mesh.all_reduce(y, axis)


def _data_mean(t: torch.Tensor, mesh, dtuple) -> torch.Tensor:
    """The mean over the data axes (JAX's ``pmean``), differentiated as
    every data rank's loss summed under autograd."""
    n = mesh.size(dtuple)
    if torch.is_grad_enabled() and t.requires_grad:
        return parallel.sum_data(t, mesh, dtuple) / n
    return mesh.all_reduce(t, dtuple) / n


def sharded_routed_experts(params: dict, x: torch.Tensor, cfg: MoEConfig,
                           act: str, capacity_mode: str, *,
                           n_shards: Optional[int] = None, mesh=None,
                           data_axes: Sequence[str] = (),
                           expert_axis: str = "model",
                           weights_2d: bool = False,
                           tables: Optional[dict] = None,
                           with_counts: bool = False, with_aux: bool = False,
                           count_weights: Optional[torch.Tensor] = None,
                           transport=None):
    """M2N routed-experts computation over ``n_shards`` expert shards in
    this process, or over the ``expert_axis`` of ``mesh`` with one shard
    per rank.

    x: (T, d) (with a data axis: this rank's rows).  Returns y (T, d) in
    x's dtype, followed by the load-balance loss with ``with_aux`` (0
    on the kernel path, as under the JAX package's kernel path; no decode
    path reads it) and by the (E,) per-expert routed-token counts
    weighted by ``count_weights`` (T,) with ``with_counts`` (the live
    traffic trace of the serving engine's load balancer; every shard
    routes the same tokens, so they are shard 0's).

    Without ``tables`` the E experts are padded to N * e_loc buckets
    (e_loc = ceil(E / N)) and shard j owns buckets [j e_loc, (j+1)
    e_loc).  A bucket past E is never routed to, so a shard's MLP runs
    over its real experts only: views of ``params["we*"]``, no padded
    copy.  With ``tables`` (``rep_node``/``rep_slot``/``rep_cum`` (E, R)
    tensors and int ``slots_per_node`` S, as ``core.load_balance``'s
    ``PlacementTables``), ``params["we*"]`` are the (N*S, ...)
    virtual-slot weights and shard j takes the view of slots [j S,
    (j+1) S).  With a ``mesh``, ``params["we*"]`` hold this rank's
    shard only (``expert_shard`` cuts it), d_ff split over the data
    axes with ``weights_2d``.

    transport: the combine's wire bytes (``m2n_traffic_bytes``) go on it
    as one ``collective`` hop.

    Under autograd, with a ``mesh``, the JAX package's plain branch runs
    (``use_kernels=False``: ``moe.route``, ``dispatch_indices(valid=local)``,
    three einsums, the load-balance loss averaged over the data axes): a
    train step's (the kernels have no backward); ``weights_2d`` always
    runs it.  Routing and capacity are then per data block (every
    data rank's rows, or the gathered rows under ``weights_2d``), as in
    JAX, and the step's gradients are JAX's: every collective is an
    autograd function of ``models.parallel``."""
    E = cfg.n_experts
    T, d = x.shape
    dtuple = tuple(data_axes)
    if mesh is not None:
        if n_shards not in (None, mesh.size(expert_axis)):
            raise ValueError(f"n_shards {n_shards} but the {expert_axis!r} "
                             f"axis has {mesh.size(expert_axis)} ranks")
        n_shards = mesh.size(expert_axis)
    elif weights_2d:
        raise NotImplementedError("weights_2d shards d_ff over a data axis, "
                                  "which needs a mesh of processes")
    elif dtuple:
        raise ValueError("a data axis needs a mesh of processes")
    if weights_2d and tables is not None:
        raise NotImplementedError("placement tables are not supported with "
                                  "weights_2d")
    w1, w3, w2 = params["we1"], params["we3"], params["we2"]
    tk = {}
    if tables is not None:
        e_loc = int(tables["slots_per_node"])
        tk = {k: tables[k] for k in ("rep_node", "rep_slot", "rep_cum")}
        n_all = n_shards * e_loc
    else:
        e_loc = -(-E // n_shards)
        n_all = E
    span = lambda j: (j * e_loc, min(n_all, (j + 1) * e_loc))
    n_data = mesh.size(dtuple) if dtuple else 1
    aux = None
    if mesh is None:
        if tables is not None and w1.shape[0] != n_all:
            raise ValueError(f"placed expert weights must be gathered to "
                             f"(N*S={n_all}, ...), got {tuple(w1.shape)}")
        cap = moe_lib.expert_capacity(T, cfg, capacity_mode)
        y, counts = None, None
        for j in range(n_shards):
            lo, hi = span(j)
            part, c = _shard(params, (w1[lo:hi], w3[lo:hi], w2[lo:hi]), x, cfg,
                             act, cap, j, n_shards, e_loc, max(0, hi - lo), tk,
                             count_weights)
            counts = c if counts is None else counts
            y = part if y is None else y + part      # the psum, in shard order
    else:
        j = mesh.index(expert_axis)
        lo, hi = span(j)
        n_real = max(0, hi - lo)
        if w1.shape[0] != n_real:
            raise ValueError(f"rank {j} of {expert_axis!r} holds experts "
                             f"[{lo}, {hi}): its weights must have {n_real} "
                             f"rows, got {tuple(w1.shape)}")
        plain = torch.is_grad_enabled() and (x.requires_grad or w1.requires_grad)
        if weights_2d or plain:
            if plain and tables is not None:
                raise NotImplementedError("placement tables are not supported "
                                          "on the plain branch")
            x_all = _rows_over(mesh, dtuple, x) if weights_2d else x
            cw = count_weights if count_weights is not None else \
                x.new_ones((T,), dtype=torch.float32)
            cw = _rows_over(mesh, dtuple, cw.float()) if weights_2d else cw
            cap = moe_lib.expert_capacity(x_all.shape[0], cfg, capacity_mode)
            part, aux, counts = _shard_plain(
                params, (w1, w3, w2), x_all, cfg, act, cap, j, e_loc, n_real, cw,
                mesh, expert_axis, dtuple if weights_2d else ())
            if weights_2d:
                # the rank's rows of the partial, summed over the expert axis
                i = mesh.index(dtuple)
                y = _expert_sum(part[i * T:(i + 1) * T], mesh, expert_axis)
            else:
                y = _expert_sum(part, mesh, expert_axis)
                if dtuple:      # routing ran per data rank over its rows
                    mesh.all_reduce(counts, dtuple)
            if dtuple:
                aux = _data_mean(aux, mesh, dtuple)
        else:
            cap = moe_lib.expert_capacity(T, cfg, capacity_mode)
            y, counts = _shard(params, (w1, w3, w2), x, cfg, act, cap, j,
                               n_shards, e_loc, n_real, tk, count_weights)
            y = _expert_sum(y, mesh, expert_axis)
            if dtuple:          # routing ran per data rank over its rows
                mesh.all_reduce(counts, dtuple)
    if transport is not None and n_shards > 1:
        transport.record_collective(
            m2n_traffic_bytes(T * n_data, d, cfg.top_k, E, n_shards,
                              x.element_size())["m2n"], fanout=n_shards)
    out = (y.to(x.dtype),)
    if with_aux:
        out += (aux if aux is not None else x.new_zeros((), dtype=torch.float32),)
    if with_counts:
        out += (counts,)
    return out if len(out) > 1 else out[0]


def expert_shard(params: dict, cfg: MoEConfig, n_shards: int, j: int, *,
                 n_data: int = 1, i: int = 0) -> dict:
    """Shard j's expert weights of the whole ``params``: ``we1`` / ``we3`` /
    ``we2`` cut to the real experts shard j owns (possibly none), and
    with ``n_data`` > 1 (``weights_2d``) to data rank i's slice of d_ff.
    The other entries pass through."""
    e_loc = -(-cfg.n_experts // n_shards)
    lo, hi = j * e_loc, min(cfg.n_experts, (j + 1) * e_loc)
    f = params["we1"].shape[-1]
    if f % n_data:
        raise ValueError(f"d_ff {f} does not split over {n_data} data ranks")
    fs = slice(i * f // n_data, (i + 1) * f // n_data)
    return dict(params, we1=params["we1"][lo:hi, :, fs],
                we3=params["we3"][lo:hi, :, fs], we2=params["we2"][lo:hi, fs])


@contextlib.contextmanager
def use_m2n(n_shards: Optional[int] = None, *, mesh=None,
            data_axes: Sequence[str] = (), expert_axis: str = "model",
            weights_2d: bool = False, transport=None):
    """Route every ``moe_ffn`` through the M2N dispatch within the block:
    over ``n_shards`` expert shards in this process, or over ``mesh``
    (see ``sharded_routed_experts``); ``transport`` accounts each
    dispatch's combine bytes."""

    def impl(params, x, cfg, act, capacity_mode, with_aux=False):
        out = sharded_routed_experts(
            params, x, cfg, act, capacity_mode, n_shards=n_shards, mesh=mesh,
            data_axes=data_axes, expert_axis=expert_axis,
            weights_2d=weights_2d, with_aux=with_aux, transport=transport)
        return out if with_aux else (out, None)

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
