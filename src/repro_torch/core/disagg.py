"""Disaggregated expert parallelism runtime (paper §3-§4) on one card.

The JAX package places the attention stage and the expert stage on two
disjoint device meshes and gets their overlap from async dispatch.  On
one H100 the two stages run on two CUDA streams instead:

  * the attention stream (the caller's current stream) runs attention,
    the fused router/top-k/dispatch kernel and the combine;
  * the expert stream runs the grouped expert MLP;
  * the M2N hop is an event recorded on the attention stream that the
    expert stream waits on, the N2M hop the reverse.  Both go through
    the runtime's ``core.transport`` ledger, which counts the bytes the
    hop would carry between nodes.

Work is issued in the order of ``pingpong.build_schedule``, double
buffered: after attn(mb) and expert(mb) are issued, the previous
micro-batch's return hop and combine are issued, so while the expert
stream computes expert(mb) the attention stream computes attn(mb+1).
A tensor made on one stream and read on the other is marked with
``record_stream`` so the caching allocator does not hand its memory out
again before the reader is done.

``expert_nodes`` is the count of expert nodes the placement and the m2n
dispatch are solved for: the one-card counterpart of the JAX runtime's
expert devices.  Two options follow the JAX runtime:

  * ``DisaggPlan.use_m2n``: the expert stream runs the M2N dispatch
    (``core.m2n``) over ``expert_nodes`` shards, routing included; the
    attention stream sends it the (T, d) activations and gets back the
    combined (T, d) output and the shard's routing counts;
  * live expert placement (``apply_placement``, paper §6): the expert
    weights are regathered node-major into ``expert_nodes *
    placement_slots`` virtual slots, hot experts replicated, and the
    dispatch maps each (token, k) to one replica by the token hash
    (``gating_dispatch``'s placement tables).  The output stays
    token-identical to the static placement.

On the CPU (``device="cpu"`` parameters) there are no streams and the
same schedule runs in order; the kernels take their plain versions.

Per-stage times (``stage_report``) are device times from CUDA events on
the card and host times on the CPU.  The M2N and N2M hops are timed as
what the transport prices them at (``TransportHandle.sim_s``): a stream
wait moves no bytes, so its device time is 0.  That sets T_c, and with
T_a and T_e the micro-batch count of paper eq. 3 (``auto_microbatches``).
What a hop does cost on one card is the destination stream's stall on
the source, timed by two CUDA events around the wait
(``m2n_wait_s`` / ``n2m_wait_s``): the ping-pong balance of the two
streams.  Every stage and hop is also a ``runtime.*`` span
(``repro_torch.trace``) while a profiler records.

Per-micro-batch cache rows are views of the engine's cache, and the
attention sublayer writes the new K/V token into them in place, so no
cache merge follows the step (the JAX runtime rebuilt the cache).

On one card the plain-PyTorch chains of the attention stream (the
attention sublayer around its kernel, the combine, the embedding and the
LM head) replay from CUDA graphs captured at the step's shapes, from the
second step of those shapes on (``core.graphs``); the kernels, the
hops and the stage events stay eager calls.

On ranks (a ``MultiControllerTransport`` whose ``setup_serving`` placed
the attention and the expert group on disjoint ranks, the JAX
runtime's two meshes) each rank runs its own stage, issuing its
collectives in the order of ``pingpong.build_schedule``:

  * an attention rank owns a contiguous run of the m micro-batches
    (``even_partition(m, A)``: the "dp" of JAX's attention mesh, whole
    micro-batches, so each is routed as in one process) and their KV
    rows.  It sends micro-batch i's M2N hop (asynchronous), posts the
    receive of its N2M return, and issues attention for i + 1 before it
    waits on i's return;
  * an expert rank holds E / N whole experts (JAX's ``P("ep")``) or, for
    a dense FFN, its column block of w1 / w3 and row block of w2, and
    serves every micro-batch in schedule order: without M2N it receives
    only its experts' capacity rows (a broadcast in the pair group of
    the attention rank and itself) and returns their outputs the same
    way; with M2N the (T, d) activations come to every expert rank (a
    broadcast in the attention rank's micro-batch group), the group runs
    ``m2n.sharded_routed_experts`` over its ranks (``GroupMesh`` "ep") and
    its first rank returns the combined rows; a dense FFN's partial
    outputs are summed in the N2M hop (a zero-filled ``all_reduce``).

The attention rank accounts both hops of its micro-batches (JAX's
bytes), every rank records its waits.  ``stage_report`` and the routing
counts are merged over the decode ranks, so every rank reads the same.
With one decode rank both groups are that rank: the two-stream runtime
above, unchanged.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import load_balance as lb_lib
from repro_torch.core import m2n as m2n_lib
from repro_torch.core import pingpong
from repro_torch.core.graphs import ChainCache, DecodeChains
from repro_torch.core.transport import InProcessTransport
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import GroupMesh
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import rms_norm
from repro_torch.models.ffn import gated_ffn
from repro_torch.models.transformer import (embed_tokens, init_cache, lm_head,
                                            self_attn_decode_sublayer)
from repro_torch.trace import span

EXPERT_KEYS = ("we1", "we3", "we2")
DENSE_KEYS = ("w1", "w3", "w2")
# pipeline stages timed by the runtime (attention compute, M2N dispatch
# hop, expert compute, N2M return hop, attention-side combine)
STAGES = ("attn", "m2n", "expert", "n2m", "combine")
# the stalls of a hop's destination stream on its source, by hop: the
# expert stream waiting for a micro-batch (m2n), the attention stream
# waiting for its return (n2m)
WAITS = ("m2n_wait", "n2m_wait")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def microbatch_owners(attn_ranks: Sequence[int], m: int) -> List[int]:
    """The attention rank of each of ``m`` micro-batches: contiguous
    runs over ``attn_ranks``, ``even_partition(m, A)``."""
    if m < len(attn_ranks):
        raise ValueError(f"{m} micro-batches for {len(attn_ranks)} attention "
                         f"ranks: each attention rank serves whole micro-batches")
    out = []
    for a, part in zip(attn_ranks, pingpong.even_partition(m, len(attn_ranks))):
        out += [a] * (part.stop - part.start)
    return out


def check_expert_group(cfg: ModelConfig, n: int):
    """Raise unless an expert group of ``n`` ranks splits the model's
    experts into whole blocks (JAX's ``P("ep")`` of the (E, ...) expert
    weights), or a dense FFN's hidden width into column blocks."""
    if cfg.moe is not None and cfg.moe.n_experts % n:
        raise ValueError(f"an expert group of {n} ranks does not divide the "
                         f"{cfg.moe.n_experts} experts of {cfg.name}: each "
                         f"expert rank holds E / N whole experts")
    if cfg.moe is None and cfg.d_ff % n:
        raise ValueError(f"an expert group of {n} ranks does not divide "
                         f"{cfg.name}'s d_ff {cfg.d_ff}")


def rank_params(cfg: ModelConfig, params: dict, roles, rank: int, *,
                use_m2n: bool = False, inline_prefill: bool = False) -> dict:
    """The leaves rank ``rank`` of the layout ``roles`` keeps of the
    whole ``params``: a prefill rank, the one decode rank, and an
    attention rank that prefills inline keep everything (their prefill
    reads every leaf); an attention rank otherwise everything but the
    expert (or dense FFN) weights; an expert rank its block of E / N
    whole experts, copied so the rest can be freed (with M2N also the
    router, which JAX replicates on the expert mesh), or a dense FFN's
    column block of w1 / w3 and row block of w2.  Leaves already cut to
    the rank's block (``rank_place``) are kept as they are."""
    place = rank_place(cfg, roles, rank, use_m2n=use_m2n,
                       inline_prefill=inline_prefill)
    return params if place is None else _placed(params, place)


def rank_place(cfg: ModelConfig, roles, rank: int, *, use_m2n: bool = False,
               inline_prefill: bool = False):
    """What rank ``rank`` keeps of each leaf, as ``init_params``' ``place``
    (``place(path, leaf)``: the leaf, its block, or an empty tensor where
    the rank keeps nothing of it), so the rank can draw its part of the
    model leaf by leaf, never holding it whole; None where the rank keeps
    every leaf."""
    role = roles.role(rank)
    if role in ("prefill", "attn+expert") or (role == "attn" and inline_prefill):
        return None
    split = EXPERT_KEYS if cfg.moe is not None else DENSE_KEYS
    if role == "attn":
        def place(path, t):
            parts = path.split("/")
            keep = (parts[0] in ("embed", "final_norm", "lm_head")
                    or (parts[0] == "layers" and parts[-1] not in split))
            return t if keep else t.new_empty((0,))
        return place
    if role != "expert":
        raise ValueError(f"rank {rank} has no stage in {roles}")
    n, j = len(roles.expert), roles.expert.index(rank)
    check_expert_group(cfg, n)
    kept = split + (("router", "router_bias") if use_m2n and cfg.moe is not None
                    else ())

    def place(path, t):
        parts = path.split("/")
        if parts[0] != "layers" or parts[-1] not in kept:
            return t.new_empty((0,))
        return _expert_block(cfg, parts[-1], t, n, j)
    return place


def _placed(tree, place, prefix: str = ""):
    """``place`` of every leaf of ``tree``, without the leaves it empties
    and the dict entries left with no leaf (list entries keep their
    places: a layer stays a layer)."""
    if isinstance(tree, torch.Tensor):
        return place(prefix, tree)
    if isinstance(tree, dict):
        out = {k: _placed(v, place, f"{prefix}/{k}" if prefix else k)
               for k, v in tree.items()}
        return {k: v for k, v in out.items() if any(t.numel() for t in _tensors(v))}
    return type(tree)(_placed(v, place, f"{prefix}/{i}") for i, v in enumerate(tree))


def _expert_block(cfg: ModelConfig, name: str, t: torch.Tensor, n: int, j: int):
    """Expert rank j of n's block of the leaf ``name`` (a copy): E / n whole
    experts, or a dense FFN's column block of w1 / w3 and row block of w2;
    a leaf already cut to it as it is."""
    if cfg.moe is not None:
        b = cfg.moe.n_experts // n
        return (t[j * b:(j + 1) * b].clone()
                if name in EXPERT_KEYS and t.shape[0] == cfg.moe.n_experts else t)
    f = cfg.d_ff // n
    if name in ("w1", "w3") and t.shape[1] == cfg.d_ff:
        return t[:, j * f:(j + 1) * f].clone()
    if name == "w2" and t.shape[0] == cfg.d_ff:
        return t[j * f:(j + 1) * f].clone()
    return t


@dataclass
class DisaggPlan:
    n_microbatches: int = 3
    capacity_mode: str = "full"
    # route MoE layers through the M2N dispatch (core.m2n) on the expert
    # stream: routing per expert shard, only the shard's tokens gathered,
    # the combine the sum of the shards' partials
    use_m2n: bool = False
    # wait for each stage's end event as it is issued, so stage_report()
    # gives each stage's device time alone (serialises the pipeline; off,
    # the stages overlap and the events are read lazily)
    profile_stages: bool = False
    # per-node virtual expert slot budget for live placements, as a
    # multiple of ceil(E/N): headroom for hot-expert replicas (§6)
    replication_slots: float = 2.0


class DisaggregatedInstance:
    """One model replica served with disaggregated expert parallelism."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 plan: Optional[DisaggPlan] = None, *, expert_nodes: int = 1,
                 transport=None):
        """``expert_nodes``: the expert nodes the placement and the m2n
        dispatch are solved for.  ``transport``: the ledger every hop
        goes through (default a private ``InProcessTransport``); the
        serving engine reports the same one."""
        if expert_nodes < 1:
            raise ValueError(f"expert_nodes must be >= 1, got {expert_nodes}")
        roles = getattr(transport, "roles", None)
        # across ranks: this rank's stage of a layout whose attention and
        # expert groups are disjoint
        self.on_ranks = roles is not None and roles.disjoint
        if self.on_ranks:
            if expert_nodes not in (1, len(roles.expert)):
                raise ValueError(f"expert_nodes={expert_nodes}, but the expert "
                                 f"group has {len(roles.expert)} ranks")
            expert_nodes = len(roles.expert)
            check_expert_group(cfg, expert_nodes)
        # the JAX runtime's rule: self-attention layers with an FFN only
        # (recurrent, SSD and cross layers have no attention/expert split)
        for kind in cfg.layer_kinds:
            if kind not in ("attn", "local"):
                raise NotImplementedError(
                    f"disaggregated runtime does not support layer kind "
                    f"{kind!r} ({cfg.name}); use the monolithic engine")
        self.cfg = cfg
        self.plan = plan if plan is not None else DisaggPlan()
        self.transport = (transport if transport is not None
                          else InProcessTransport())
        self.n_expert_nodes = expert_nodes
        split = EXPERT_KEYS if cfg.moe is not None else DENSE_KEYS
        self.rank, self.role, self.roles = 0, "attn+expert", roles
        if roles is not None:
            self.rank = transport.process_index
            self.role = roles.role(self.rank)
        if self.on_ranks:
            params = rank_params(cfg, params, roles, self.rank,
                                 use_m2n=self.plan.use_m2n)
        leaf = next(t for t in _tensors(params))
        self.device, self.dtype = leaf.device, (
            params["embed"].dtype if "embed" in params else leaf.dtype)
        is_attn = self.role in ("attn", "attn+expert")
        is_expert = self.role in ("expert", "attn+expert")
        # the two stages share the caller's parameter tensors (no copy);
        # a rank keeps what its stage reads
        self.layers_attn = ([{k: v for k, v in lp.items() if k not in split}
                             for lp in params["layers"]] if is_attn else None)
        self.layers_expert = ([{k: lp[k] for k in split} for lp in params["layers"]]
                              if is_expert else None)
        self.layers_router = ([{k: lp[k] for k in ("router", "router_bias")
                                if k in lp} for lp in params["layers"]]
                              if is_expert and self.on_ranks and cfg.moe is not None
                              and self.plan.use_m2n else None)
        self.head = ({k: params[k] for k in ("embed", "final_norm", "lm_head")
                      if k in params} if is_attn else {})
        self.expert_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" and not self.on_ranks
                              else None)
        if self.on_ranks:
            self._expert_mesh = GroupMesh("ep", roles.expert,
                                          transport.groups["expert"])
        E = cfg.moe.n_experts if cfg.moe is not None else 0
        # the live traffic trace: per-expert routed-token counts of the
        # live rows, added on the attention stream
        self.expert_counts = torch.zeros(E, dtype=torch.float32,
                                         device=self.device)
        self._active: Optional[torch.Tensor] = None
        # live expert placement (§6): static (contiguous expert blocks)
        # until apply_placement installs tables and virtual-slot weights
        self.placement: Optional[lb_lib.Placement] = None
        self.tables: Optional[lb_lib.PlacementTables] = None
        self.layers_expert_placed: Optional[List[dict]] = None
        self._slot_experts: Optional[np.ndarray] = None   # expert in each slot
        self._tables_dev: Optional[dict] = None
        if cfg.moe is not None:
            e_loc = -(-E // expert_nodes)
            self.placement_slots = min(
                E, max(e_loc, int(round(e_loc * self.plan.replication_slots))))
        else:
            self.placement_slots = 0
        # the attention stream's plain-PyTorch chains, replayed from CUDA
        # graphs on one card (core.graphs)
        self._chain_cache = ChainCache()
        self.reset_stage_times()
        self.last_trace: List[tuple] = []

    # ------------------------------------------------------------ stages
    def _attn_phase(self, p, x, act, cache, pos, window, tbl=None):
        cfg = self.cfg
        x = x + self_attn_decode_sublayer(p, cfg, x, pos, cache, window)
        h = rms_norm(x, p["ln2"])
        if cfg.moe is None or self.plan.use_m2n:
            # m2n: routing and dispatch run on the expert stream; only the
            # (T, d) activations cross
            return x, h, None
        idx_buf, gate_buf, counts = self._route(p, h, act, tbl)
        xe = moe_lib.gather_tokens(h, idx_buf)                 # (rows, C, d)
        return x, h, {"xe": xe, "idx": idx_buf, "gates": gate_buf,
                      "counts": counts}

    def _route(self, p, h, act, tbl):
        """The router, top-k and capacity dispatch of the (T, d) rows h:
        (idx (rows, C) int32, gates (rows, C) f32, counts (E,) f32)."""
        cfg = self.cfg
        cap = moe_lib.expert_capacity(h.shape[0], cfg.moe,
                                      self.plan.capacity_mode)
        if tbl is None:
            n_buckets, spn, tk = cfg.moe.n_experts, 0, {}
        else:
            # live placement: each (token, k) goes to one replica of its
            # expert, a virtual slot of the node-major (N*S, ...) weights.
            # Same expert weights, same combine: token-identical output
            n_buckets = self.n_expert_nodes * self.placement_slots
            spn, tk = self.placement_slots, tbl
        # fused router + top-k + capacity dispatch; act (the live-row
        # weights) keeps idle KV rows out of the traffic counts
        return kops.gating_dispatch(
            h, p["router"], cfg.moe.top_k, n_buckets=n_buckets,
            capacity=cap, bias=p.get("router_bias"), count_weights=act,
            slots_per_node=spn, **tk)

    def _dispatch_rows(self) -> int:
        """Rows of the dispatch table: the experts, or the virtual slots of
        an applied placement (0 for a dense FFN)."""
        if self.cfg.moe is None:
            return 0
        if self.layers_expert_placed is None:
            return self.cfg.moe.n_experts
        return self.n_expert_nodes * self.placement_slots

    def _expert_phase(self, pe, payload, idx=None, n_tokens=None, out=None):
        """The routed experts on the (rows, C, d) payload; with the dispatch
        table ``idx`` (sentinel ``n_tokens``) the kernel skips the empty
        slots past each expert's last routed one; ``out``: a buffer for
        the output."""
        if self.cfg.moe is not None:
            return kops.grouped_mlp(payload, pe["we1"], pe["we3"], pe["we2"],
                                    self.cfg.act, idx=idx, n_tokens=n_tokens,
                                    out=out)
        return gated_ffn(payload, pe["w1"], pe["w3"], pe["w2"], self.cfg.act)

    def _expert_phase_m2n(self, pe, pa, h, act, tbl=None):
        """The M2N dispatch over the expert nodes, routing included: (T, d)
        output in h's dtype and one shard's (E,) routing counts."""
        router = {k: pa[k] for k in ("router", "router_bias") if k in pa}
        tables = (None if tbl is None
                  else dict(tbl, slots_per_node=self.placement_slots))
        y, counts = m2n_lib.sharded_routed_experts(
            dict(pe, **router), h, self.cfg.moe, self.cfg.act,
            self.plan.capacity_mode, n_shards=self.n_expert_nodes,
            tables=tables, with_counts=True, count_weights=act)
        return {"y": y, "counts": counts}

    def _combine_phase(self, p, x, h, out, disp):
        cfg = self.cfg
        if cfg.moe is not None and self.plan.use_m2n:
            # out["y"]: the routed output, gate-weighted and combined over
            # the expert shards already
            y = moe_lib.add_dense_extras(p, h, out["y"], cfg.act)
        elif cfg.moe is not None:
            y = moe_lib.combine(out, disp["idx"], disp["gates"],
                                x.shape[0]).to(x.dtype)
            # shared experts / dense residual stay with attention
            y = moe_lib.add_dense_extras(p, h, y, cfg.act)
        else:
            y = out
        if cfg.use_post_norm:
            y = rms_norm(y, p["ln2_post"])
        return x + y

    # ------------------------------------------------------ stage timing
    def reset_stage_times(self):
        self.stage_times = {s: 0.0 for s in STAGES + WAITS}
        self.stage_counts = {s: 0 for s in STAGES}
        self._pending_events = []
        # attention-stream stages run from CUDA graph replays, and captures
        self.graphed_n = self.captures = 0

    def _timed(self, stage: str, stream, fn, *args):
        """Run one stage on ``stream``.  On the card its device time is
        taken with CUDA events (read lazily by ``stage_report``, so the
        pipeline never blocks, unless ``plan.profile_stages``); on the
        CPU with the host clock."""
        self.stage_counts[stage] += 1
        with span(f"runtime.{stage}"):
            if stream is None:
                t0 = time.perf_counter()
                out = fn(*args)
                self.stage_times[stage] += time.perf_counter() - t0
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                start.record(stream)
                out = fn(*args)
                end.record(stream)
            if self.plan.profile_stages:
                end.synchronize()
            self._pending_events.append((stage, start, end))
            return out

    def stage_report(self) -> dict:
        """Cumulative per-stage seconds and counts, plus the paper's
        per-op T_a (attention + combine), T_e (expert) and T_c (one
        hop), the port's count of stream hops, and how long each hop's
        destination stream stalled on its source (``m2n_wait_s``: the
        expert stream waiting for micro-batches, ``n2m_wait_s``: the
        attention stream waiting for their returns; 0 on the CPU and
        across ranks, where a hop is no stream wait).

        T_c differs in origin from the JAX runtime's: there it is the
        host wall time of a cross-mesh ``device_put``, which has no
        counterpart on one card.  Here a hop is a stream wait, so its
        seconds are what the transport prices it at: 0 under
        ``inproc``, the ``RdmaCostModel`` latency under ``simrdma``.

        ``graphed_n``: the attention and combine stages that ran from CUDA
        graph replays (``core.graphs``); ``captures``: how often the
        chains were captured (both 0 on the CPU and across ranks)."""
        for stage, start, end in self._pending_events:
            end.synchronize()
            self.stage_times[stage] += start.elapsed_time(end) / 1e3
        self._pending_events = []
        rep = {f"{s}_s": self.stage_times[s] for s in STAGES}
        rep.update({f"{s}_n": self.stage_counts[s] for s in STAGES})
        rep["t_a"] = ((self.stage_times["attn"] + self.stage_times["combine"])
                      / max(1, self.stage_counts["attn"]))
        rep["t_e"] = (self.stage_times["expert"]
                      / max(1, self.stage_counts["expert"]))
        rep["hops"] = self.stage_counts["m2n"] + self.stage_counts["n2m"]
        rep["t_c"] = ((self.stage_times["m2n"] + self.stage_times["n2m"])
                      / max(1, rep["hops"]))
        rep.update({f"{w}_s": self.stage_times[w] for w in WAITS})
        rep["graphed_n"], rep["captures"] = self.graphed_n, self.captures
        # across ranks every decode rank takes part, and reads the same
        return self._stage_report_ranks(rep) if self.on_ranks else rep

    def measure_stage_times(self, batch: int, max_seq: int = 32) -> dict:
        """Profile one decode iteration of ``batch`` rows on a throwaway
        cache, after one warm-up iteration, and return its
        ``stage_report()`` with device-accurate stage times.  The cache
        is made in the parameters' dtype (the JAX runtime makes it in
        f32; the CUDA kernels take the cache in the weights' dtype).
        The live traffic trace (its routing counts and active rows) is
        left as it was."""
        cfg = self.cfg
        tokens = torch.zeros(batch, dtype=torch.int64, device=self.device)
        pos = torch.zeros(batch, dtype=torch.int32, device=self.device)
        rows = (self.attn_rows(pingpong.even_partition(batch, self.plan.n_microbatches))
                if self.on_ranks else slice(0, batch))
        cache = (init_cache(cfg, rows.stop - rows.start, max_seq, dtype=self.dtype,
                            device=self.device) if rows is not None else None)
        counts, active = self.expert_counts.clone(), self._active
        prev = self.plan.profile_stages
        self.plan.profile_stages = True
        self._active = None
        try:
            self.decode_step(tokens, cache, pos)       # warm-up
            self.reset_stage_times()
            self.decode_step(tokens, cache, pos)
            report = self.stage_report()
        finally:
            self.plan.profile_stages = prev
            self.reset_stage_times()
            self.expert_counts.copy_(counts)
            self._active = active
        return report

    def auto_microbatches(self, batch: int, *, max_m: Optional[int] = None,
                          max_seq: int = 32) -> int:
        """The micro-batch count from measured T_a / T_e / T_c (the
        feasibility bound of paper eq. 3)."""
        rep = self.measure_stage_times(batch, max_seq)
        return pingpong.choose_microbatches(rep["t_a"], rep["t_e"], rep["t_c"],
                                            max_m=max_m)

    # ------------------------------------------------------ stream hops
    def _hop(self, stage: str, payload, src, dst, *, fanout: int = 1,
             also=()):
        """The ``stage`` hop ("m2n" or "n2m"): hand ``payload`` from
        stream ``src`` to stream ``dst`` through the transport.  ``dst``
        waits for everything issued on ``src`` so far, the allocator
        keeps the memory of ``payload`` and of the tensors in ``also``
        until ``dst`` is done with them, the ledger counts ``payload``'s
        bytes times ``fanout``, and the stage is timed at the hop's
        priced latency.  On the card two events on ``dst`` around the
        transport's stream wait time the stall of ``dst`` on ``src``."""
        with span(f"runtime.{stage}"):
            if dst is not None:
                before = torch.cuda.Event(enable_timing=True)
                before.record(dst)
            h = self.transport.send_tokens(payload, dst, src=src, fanout=fanout)
            self.stage_counts[stage] += 1
            self.stage_times[stage] += h.sim_s
            if dst is not None:
                after = torch.cuda.Event(enable_timing=True)
                after.record(dst)
                self._pending_events.append((f"{stage}_wait", before, after))
                for t in also:
                    t.record_stream(dst)

    def _account_combine(self, t_tokens: int, d_model: int, itemsize: int):
        """The m2n combine (a reduce-scatter plus an all-gather over the
        expert nodes: 2 T d (N-1)/N bytes) as a collective hop, as the
        JAX runtime accounts it."""
        n = self.n_expert_nodes
        if n > 1:
            nbytes = 2 * t_tokens * d_model * itemsize * (n - 1) // n
            self.transport.record_collective(nbytes, fanout=n)

    # ----------------------------------------------- live expert placement
    def apply_placement(self, placement: lb_lib.Placement) -> bool:
        """Install a (possibly replicated) expert placement (paper §6).

        The fractional ``Placement`` is compiled to lookup tables under
        the fixed per-node slot budget ``placement_slots``, and every MoE
        layer's expert weights are regathered node-major into
        (N*S, ...) virtual-slot tensors: a replicated hot expert holds
        one slot on each node that hosts it.  The shapes do not depend on
        the placement, so a later placement is written into the same
        tensors, after the card has drained (no stage still reads the old
        slots): at full width a second placed copy would not fit beside
        the first.  Only the slots whose expert changed are rewritten,
        one copy per slot and weight (a gather of whole experts with
        ``index_select`` ran at ~0.26 TB/s on the H100), and the ledger's
        "weights" hop counts those bytes (the JAX runtime uploads every
        slot).  The replica of a (token, k) is picked by the token hash,
        so the output stays token-identical to the static placement.

        Returns True when the placement was installed, False when the
        solved tables match the ones being served (steady state) and the
        regather was skipped."""
        if self.cfg.moe is None:
            raise ValueError("expert placement needs an MoE config")
        if self.plan.capacity_mode != "full":
            # a replicated expert's tokens are split over several buckets,
            # so bounded capacity would drop other tokens than the static
            # path: token identity holds for the drop-free capacity only
            raise ValueError(
                f"live placement requires capacity_mode='full' (drop-free); "
                f"got {self.plan.capacity_mode!r}")
        tables = lb_lib.placement_tables(placement, self.placement_slots)
        if tables.n_nodes != self.n_expert_nodes:
            raise ValueError(f"placement solved for {tables.n_nodes} nodes, "
                             f"runtime has {self.n_expert_nodes}")
        if self._placement_unchanged(tables):
            return False
        flat = tables.slot_experts.reshape(-1)
        src = np.where(flat < 0, 0, flat)          # pad slots hold expert 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.on_ranks:
            if self.layers_expert is not None:
                self._regather_ranks(np.where(flat < 0, -1, flat))
        else:
            if self.layers_expert_placed is None:
                self.layers_expert_placed = [
                    {k: raw[k].new_empty((flat.size,) + tuple(raw[k].shape[1:]))
                     for k in EXPERT_KEYS} for raw in self.layers_expert]
                changed = np.arange(flat.size)
            else:
                changed = np.nonzero(src != self._slot_experts)[0]
            moved = []
            for raw, placed in zip(self.layers_expert, self.layers_expert_placed):
                for k in EXPERT_KEYS:
                    for slot in changed.tolist():
                        placed[k][slot].copy_(raw[k][int(src[slot])])
                        moved.append(placed[k][slot])
            # the regather is the "weights" hop of the ledger
            self.transport.regather_weights(moved)
        self._slot_experts = src
        self._tables_dev = {
            k: torch.as_tensor(getattr(tables, k), dtype=dt, device=self.device)
            for k, dt in (("rep_node", torch.int32), ("rep_slot", torch.int32),
                          ("rep_cum", torch.float32))}
        self.placement = placement
        self.tables = tables
        return True

    def _placement_unchanged(self, tables: lb_lib.PlacementTables,
                             cum_tol: float = 0.05) -> bool:
        """True when ``tables`` would serve (essentially) the placement
        already installed: the same expert->slot layout and replica
        traffic splits within ``cum_tol``.  Any placement is correct, so
        keeping a split that moved by less only leaves the traffic shares
        slightly stale."""
        cur = self.tables
        return (cur is not None
                and np.array_equal(cur.slot_experts, tables.slot_experts)
                and np.array_equal(cur.rep_node, tables.rep_node)
                and np.array_equal(cur.rep_slot, tables.rep_slot)
                and np.abs(cur.rep_cum - tables.rep_cum).max() <= cum_tol)

    @property
    def placement_fractions(self) -> np.ndarray:
        """The (E, N) expert->node fractions the runtime serves: the
        applied placement's, or the static contiguous blocks before any
        rebalance."""
        if self.tables is not None:
            return self.tables.fractions
        return lb_lib.static_placement(self.cfg.moe.n_experts,
                                       self.n_expert_nodes).fractions

    # ------------------------------------------------------ routing counts
    def set_active_slots(self, active):
        """Mark which KV rows serve a request ((B,) 0/1); idle rows are
        decoded anyway but kept out of the per-expert counts.  ``None``
        counts every row again."""
        self._active = (None if active is None else torch.as_tensor(
            active, dtype=torch.float32, device=self.device))

    def reset_expert_counts(self):
        """Zero the accumulated per-expert routed-token counts."""
        self.expert_counts.zero_()

    def peek_expert_counts(self) -> np.ndarray:
        """Per-expert routed-token counts since the last reset (waits
        for the attention stream); across ranks merged over the decode
        ranks, every one of which must call it."""
        counts = self._merged_counts() if self.on_ranks else self.expert_counts
        return counts.double().cpu().numpy()

    def take_expert_counts(self) -> np.ndarray:
        """``peek_expert_counts`` and a reset: one interval of live
        expert traffic for ``balance_experts``."""
        counts = self.peek_expert_counts()
        self.reset_expert_counts()
        return counts

    # ------------------------------------------------------------ decode
    def decode_step(self, tokens, cache: List[dict], pos):
        """One decode iteration of the whole batch, split into
        ``plan.n_microbatches`` near-even micro-batches: the decode step
        of the ``disagg`` runtime.  Returns (logits (B, V), cache)."""
        return self.decode_microbatched(tokens, cache, pos)

    def decode_microbatched(self, tokens, cache: List[dict], pos,
                            mb_slices: Optional[Sequence[slice]] = None):
        """Schedule-driven ping-pong decode.  tokens/pos: (B,); cache: the
        per-layer list from ``models.transformer.init_cache`` (updated in
        place).  Returns (logits (B, V), cache).  The issue order is kept
        in ``last_trace`` (comparable with ``pingpong.build_schedule``)."""
        cfg = self.cfg
        B = tokens.shape[0]
        if mb_slices is None:
            mbs = pingpong.even_partition(B, self.plan.n_microbatches)
        else:
            mbs = [s for s in mb_slices if s.stop > s.start]
            if [s.start for s in mbs] != [0] + [s.stop for s in mbs[:-1]] \
                    or (mbs and mbs[-1].stop != B):
                raise ValueError(f"micro-batch slices {mbs} must cover "
                                 f"[0, {B}) contiguously")
        if self.on_ranks:
            return self._decode_ranks(tokens, cache, pos, mbs)
        attn_s = (torch.cuda.current_stream(self.device)
                  if self.expert_stream is not None else None)
        exp_s = self.expert_stream
        trace = []
        chains = self._chains_for(B, cache, mbs)
        if chains is None:
            xs = [embed_tokens(self.head, cfg, tokens[s]) for s in mbs]
            poss = [pos[s] for s in mbs]
            act = (self._active if self._active is not None else
                   torch.ones(B, dtype=torch.float32, device=self.device))
            acts = [act[s] for s in mbs]
        else:
            chains.begin(tokens, pos, self._active)
        m2n = cfg.moe is not None and self.plan.use_m2n
        placed = self.layers_expert_placed is not None
        tbl = self._tables_dev if placed else None

        for l, kind in enumerate(cfg.layer_kinds):
            window = cfg.window if kind == "local" else 0
            pa = self.layers_attn[l]
            pe = (self.layers_expert_placed[l] if placed
                  else self.layers_expert[l])
            inflight: deque = deque()

            def drain_one():
                i, x, h, out, disp = inflight.popleft()
                if m2n:
                    self._hop("n2m", out["y"], exp_s, attn_s,
                              also=(out["counts"],))
                    # every shard counted the same tokens: one shard's
                    # counts, added once, after the hop
                    self.expert_counts += out["counts"]
                else:
                    self._hop("n2m", out, exp_s, attn_s)
                if chains is None:
                    xs[i] = self._timed("combine", attn_s, self._combine_phase,
                                        pa, x, h, out, disp)
                else:
                    self._timed("combine", attn_s, chains.combine, l, i, out)

            for i, s in enumerate(mbs):
                if chains is None:
                    entry = {k: v[s] for k, v in cache[l].items()}  # row views
                    x, h, disp = self._timed("attn", attn_s, self._attn_phase,
                                             pa, xs[i], acts[i], entry, poss[i],
                                             window, tbl)
                else:
                    x, h, disp = self._timed("attn", attn_s, chains.attn, l, i,
                                             window, tbl)
                if disp is not None:
                    self.expert_counts += disp["counts"]
                trace.append(("attn", i, l))
                if m2n:
                    # the (T, d) activations go to every expert node
                    self._hop("m2n", h, attn_s, exp_s,
                              fanout=self.n_expert_nodes, also=(acts[i],))
                    out = self._timed("expert", exp_s, self._expert_phase_m2n,
                                      pe, pa, h, acts[i], tbl)
                    self._account_combine(h.shape[0], h.shape[1],
                                          h.element_size())
                else:
                    if disp is None:
                        self._hop("m2n", h, attn_s, exp_s)
                        out = self._timed("expert", exp_s, self._expert_phase,
                                          pe, h)
                    else:
                        # the table crosses with the payload
                        self._hop("m2n", disp["xe"], attn_s, exp_s,
                                  also=(disp["idx"],))
                        out = self._timed("expert", exp_s, self._expert_phase,
                                          pe, disp["xe"], disp["idx"],
                                          h.shape[0], disp.get("out"))
                trace.append(("expert", i, l))
                inflight.append((i, x, h, out, disp))
                # double buffer: one micro-batch on the expert stream, one
                # returning and combining on the attention stream
                if len(inflight) > 1:
                    drain_one()
            while inflight:
                drain_one()

        logits = (torch.cat([lm_head(self.head, cfg, x) for x in xs], 0)
                  if chains is None else chains.head())
        self.last_trace = trace
        return logits, cache

    def chain_spec(self, batch: int, mbs: Sequence[slice],
                   cache: List[dict]) -> Optional[tuple]:
        """The shapes the attention stream's chains of a step are captured
        at (``core.graphs``), or None where the step runs eager: across
        ranks, under M2N (routing runs on the expert stream) and while
        ``profile_stages`` times each stage alone."""
        if self.on_ranks or self.plan.use_m2n or self.plan.profile_stages:
            return None
        return (batch, tuple((s.start, s.stop) for s in mbs),
                cache[0]["k"].dtype, self._dispatch_rows())

    def _chains_for(self, batch: int, cache: List[dict],
                    mbs: Sequence[slice]) -> Optional[DecodeChains]:
        """The captured chains this step replays (captured now, on the
        second step of their key), or None for an eager step.  Only on
        one card (``expert_stream``): the CPU runs every step eager."""
        if self.expert_stream is None:
            return None
        return self._chains_lookup(batch, cache, mbs)

    def _chains_lookup(self, batch: int, cache: List[dict],
                       mbs: Sequence[slice]) -> Optional[DecodeChains]:
        """``_chains_for`` past the device check: the step's action by
        ``ChainCache``, capturing where it says so."""
        spec = self.chain_spec(batch, mbs, cache)
        tensors = [t for entry in cache for t in entry.values()]
        action = self._chain_cache.action(spec, tensors)
        if action == "capture":
            with span("runtime.capture"):
                if self.device.type == "cuda":
                    # no replay of the chains dropped here is in flight
                    torch.cuda.synchronize(self.device)
                self._chain_cache.drop()
                self._chain_cache.install(DecodeChains(
                    self, cache, mbs, batch, self._dispatch_rows()))
            self.captures += 1
        return None if action == "eager" else self._chain_cache.chains

    # ------------------------------------------------------------- ranks
    def owners(self, m: int) -> List[int]:
        """The attention rank of each of ``m`` micro-batches."""
        return microbatch_owners(self.roles.attn if self.roles else (0,), m)

    def attn_rows(self, mbs: Sequence[slice]) -> Optional[slice]:
        """The batch rows (KV slots) this rank's attention stage owns for
        the micro-batches ``mbs``, or None on a rank without one."""
        if self.layers_attn is None:
            return None
        own = [s for s, a in zip(mbs, self.owners(len(mbs))) if a == self.rank]
        return slice(own[0].start, own[-1].stop)

    def _decode_ranks(self, tokens, cache, pos, mbs):
        """``decode_microbatched`` on this rank's stage: (logits of its
        rows, or None on an expert rank; cache)."""
        cfg, tr = self.cfg, self.transport
        owners = self.owners(len(mbs))
        B = tokens.shape[0]
        act = (self._active if self._active is not None else
               torch.ones(B, dtype=torch.float32, device=self.device))
        placed = self.layers_expert_placed is not None
        # an attention rank holds the tables, not the placed weights
        tbl = self._tables_dev if self.tables is not None else None
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        sends, trace = [], []
        if self.layers_attn is not None:
            own = [i for i, a in enumerate(owners) if a == self.rank]
            lo = mbs[own[0]].start
            xs = {i: embed_tokens(self.head, cfg, tokens[mbs[i]]) for i in own}
        for l, kind in enumerate(cfg.layer_kinds):
            if self.layers_attn is None:
                pe = (self.layers_expert_placed[l] if placed
                      else self.layers_expert[l])
                for i, s in enumerate(mbs):
                    sends += self._serve_expert(l, pe, s, owners[i], act[s], tbl,
                                                stream)
                    trace.append(("expert", i, l))
                continue
            window = cfg.window if kind == "local" else 0
            pa = self.layers_attn[l]
            inflight: deque = deque()

            def drain_one():
                i, x, h, back, disp = inflight.popleft()
                out = back()
                xs[i] = self._timed("combine", stream, self._combine_phase, pa, x,
                                    h, out, disp)

            for i in own:
                s = mbs[i]
                rows = slice(s.start - lo, s.stop - lo)
                entry = {k: v[rows] for k, v in cache[l].items()}
                x, h, disp = self._timed("attn", stream, self._attn_phase, pa,
                                         xs[i], act[s], entry, pos[s], window, tbl)
                if disp is not None:
                    self.expert_counts += disp["counts"]
                trace.append(("attn", i, l))
                back, sent = self._send_micro_batch(h, disp)
                sends += sent
                inflight.append((i, x, h, back, disp))
                # the return of micro-batch i is waited on only after
                # attention for i + 1 is issued
                if len(inflight) > 1:
                    drain_one()
            while inflight:
                drain_one()
        for hop in sends:
            hop.wait()
        self.last_trace = trace
        if self.layers_attn is None:
            return None, cache
        return torch.cat([lm_head(self.head, cfg, xs[i]) for i in own], 0), cache

    def _send_micro_batch(self, h, disp):
        """The attention rank's M2N hop of one micro-batch (asynchronous)
        and the receive of its N2M return, posted at once so that every
        group sees its hops in the same order on every rank.  Returns
        (a function that waits for the return and gives the expert
        output, the sends to wait on at the step's end)."""
        cfg, tr, ex = self.cfg, self.transport, self.roles.expert
        t0 = time.perf_counter()
        a = self.rank
        if cfg.moe is None or self.plan.use_m2n:
            payload = h
            sends = [tr.broadcast(h, root=a, group=tr.groups["mb", a],
                                  kind="tokens", async_op=True, account=False)]
        else:
            payload = disp["xe"]
            b = payload.shape[0] // len(ex)
            sends = [tr.broadcast(payload[j * b:(j + 1) * b].contiguous(), root=a,
                                  group=tr.pair(a, x), kind="tokens",
                                  async_op=True, account=False)
                     for j, x in enumerate(ex)]
        fan = (len(ex) if cfg.moe is not None and self.plan.use_m2n else 1)
        self._account_hop("m2n", payload, fan, time.perf_counter() - t0)
        if cfg.moe is not None and self.plan.use_m2n:
            if len(ex) > 1:
                self._account_combine(h.shape[0], h.shape[1], h.element_size())
            ret = [tr.broadcast(None, root=ex[0], group=tr.pair(a, ex[0]),
                                kind="tokens", like=h, async_op=True)]
            out = lambda: {"y": ret[0].wait()}
        elif cfg.moe is not None:
            ret = [tr.broadcast(None, root=x, group=tr.pair(a, x), kind="tokens",
                                like=payload[:b], async_op=True) for x in ex]
            out = lambda: torch.cat([r.wait() for r in ret], 0)
        else:
            ret = [tr.reduce_hop(torch.zeros_like(h), group=tr.groups["mb", a],
                                 kind="tokens", async_op=True)]
            out = lambda: ret[0].wait()

        def back():
            y = out()
            self._account_hop("n2m", y["y"] if isinstance(y, dict) else y, 1, 0.0)
            return y

        return back, sends

    def _account_hop(self, stage: str, payload, fanout: int, issue_s: float):
        """The ledger's "tokens" hop of one stage, accounted on the
        attention rank (its bytes as one process counts them), and the
        stage timed at the hop's priced latency."""
        h = self.transport.record("tokens", payload.numel() * payload.element_size()
                                  * max(1, fanout), fanout=fanout, issue_s=issue_s)
        self.stage_counts[stage] += 1
        self.stage_times[stage] += h.sim_s

    def _serve_expert(self, l, pe, s, a, act, tbl, stream):
        """One micro-batch (rows ``s`` of attention rank ``a``) on this
        expert rank: receive, compute, return.  Returns the sends to wait
        on at the step's end."""
        cfg, tr = self.cfg, self.transport
        T, d = s.stop - s.start, cfg.d_model
        me, j = self.rank, self.roles.expert.index(self.rank)
        like = torch.empty((T, d), dtype=self.dtype, device=self.device)
        if cfg.moe is not None and self.plan.use_m2n:
            h = tr.broadcast(None, root=a, group=tr.groups["mb", a], kind="tokens",
                             like=like).wait()
            router = self.layers_router[l]
            out = self._timed("expert", stream, self._expert_phase_ranks, pe,
                              router, h, act, tbl)
            self.expert_counts += out["counts"]
            if j:
                return []
            return [tr.broadcast(out["y"], root=me, group=tr.pair(a, me),
                                 kind="tokens", async_op=True, account=False)]
        if cfg.moe is not None:
            cap = moe_lib.expert_capacity(T, cfg.moe, self.plan.capacity_mode)
            b = pe["we1"].shape[0]
            xe = tr.broadcast(None, root=a, group=tr.pair(a, me), kind="tokens",
                              like=torch.empty((b, cap, d), dtype=self.dtype,
                                               device=self.device)).wait()
            out = self._timed("expert", stream, self._expert_phase, pe, xe)
            return [tr.broadcast(out, root=me, group=tr.pair(a, me),
                                 kind="tokens", async_op=True, account=False)]
        h = tr.broadcast(None, root=a, group=tr.groups["mb", a], kind="tokens",
                         like=like).wait()
        out = self._timed("expert", stream, self._expert_phase, pe, h)
        return [tr.reduce_hop(out, group=tr.groups["mb", a], kind="tokens",
                              async_op=True)]

    def _expert_phase_ranks(self, pe, router, h, act, tbl):
        """The M2N dispatch over the expert group's ranks (the owner
        branch of ``gating_dispatch`` on this rank's experts, the combine
        an ``all_reduce`` over the group): (T, d) output and the routing
        counts."""
        tables = (None if tbl is None
                  else dict(tbl, slots_per_node=self.placement_slots))
        y, counts = m2n_lib.sharded_routed_experts(
            dict(pe, **router), h, self.cfg.moe, self.cfg.act,
            self.plan.capacity_mode, mesh=self._expert_mesh, expert_axis="ep",
            tables=tables, with_counts=True, count_weights=act)
        return {"y": y, "counts": counts}

    def _merged_counts(self) -> torch.Tensor:
        """The routing counts summed over the decode ranks, each counted
        once: the attention ranks' (disjoint micro-batches) without M2N,
        the first expert rank's with it (every expert rank routes the same
        tokens)."""
        mine = self.expert_counts.clone()
        counts_here = (self.layers_attn is not None if not self.plan.use_m2n
                       else self.rank == self.roles.expert[0])
        if not counts_here:
            mine.zero_()
        return self.transport.reduce_hop(
            mine, group=self.transport.groups["decode"], kind="collective").wait()

    def _stage_report_ranks(self, local: dict) -> dict:
        """The merged stage report: the attention ranks' attn / combine /
        m2n / n2m seconds and counts summed, the expert stage's seconds
        the mean of the expert ranks' and its count the first expert
        rank's (each runs every micro-batch); t_a, t_e, t_c from those.
        ``ranks``: each decode rank's own report."""
        tr = self.transport
        mine = dict(local, rank=self.rank, role=self.role)
        reps = tr.gather_objects(mine, group=tr.groups["decode"],
                                 ranks=self.roles.decode)
        attn = [r for r in reps if r["role"] == "attn"]
        exp = [r for r in reps if r["role"] == "expert"]
        rep = {}
        for st in STAGES:
            if st == "expert":
                rep["expert_s"] = sum(r["expert_s"] for r in exp) / len(exp)
                rep["expert_n"] = exp[0]["expert_n"]
            else:
                rep[f"{st}_s"] = sum(r[f"{st}_s"] for r in attn)
                rep[f"{st}_n"] = sum(r[f"{st}_n"] for r in attn)
        rep["t_a"] = (rep["attn_s"] + rep["combine_s"]) / max(1, rep["attn_n"])
        rep["t_e"] = rep["expert_s"] / max(1, rep["expert_n"])
        rep["hops"] = rep["m2n_n"] + rep["n2m_n"]
        rep["t_c"] = (rep["m2n_s"] + rep["n2m_s"]) / max(1, rep["hops"])
        rep.update({f"{w}_s": sum(r[f"{w}_s"] for r in reps) for w in WAITS})
        for k in ("graphed_n", "captures"):
            rep[k] = sum(r[k] for r in reps)
        rep["ranks"] = reps
        return rep

    def _regather_ranks(self, src: np.ndarray):
        """Write this expert rank's virtual slots of the layout ``src``
        (the expert of every slot, node-major; -1 a pad slot, which no
        table routes to: zeroed here, where one process copies expert 0
        into it): each changed slot takes its expert's weights from the
        expert rank that holds it statically, over the pair group of the
        two (every expert rank walks the same changes in the same order),
        or from its own block.  The un-placed blocks go to the host at
        the first placement, before the slots are made, so the card keeps
        only the slots; the "weights" hop counts the rank's changed
        slots' bytes."""
        tr, ex, me = self.transport, self.roles.expert, self.rank
        S = self.placement_slots
        e_loc = self.cfg.moe.n_experts // len(ex)
        j = ex.index(me)
        if self.layers_expert_placed is None:
            shapes = [{k: (raw[k].shape, raw[k].dtype) for k in EXPERT_KEYS}
                      for raw in self.layers_expert]
            # the card copy is freed where no caller keeps a reference
            # (an expert rank's engine keeps none)
            self.layers_expert = [{k: raw[k].to("cpu", copy=True) for k in EXPERT_KEYS}
                                  for raw in self.layers_expert]
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self.layers_expert_placed = [
                {k: torch.empty((S,) + tuple(sh[k][0][1:]), dtype=sh[k][1],
                                device=self.device) for k in EXPERT_KEYS}
                for sh in shapes]
            changed = np.arange(src.size)
        else:
            changed = np.nonzero(src != np.where(self._slot_pad, -1,
                                                 self._slot_experts))[0]
        self._slot_pad = src < 0
        wire = tr._wire_device()
        pieces = lambda e: [raw[k][e] for raw in self.layers_expert
                            for k in EXPERT_KEYS]
        moved, sends = [], []
        for slot in changed.tolist():
            dst, e = ex[slot // S], int(src[slot])
            if e < 0:
                if dst == me:
                    for placed in self.layers_expert_placed:
                        for k in EXPERT_KEYS:
                            placed[k][slot - j * S].zero_()
                continue
            owner = ex[e // e_loc]
            if me not in (dst, owner):
                continue
            # one hop a weight, each a contiguous host view (nothing
            # packed); a send does not wait, so the pairs' hops overlap
            if owner == me and dst != me:
                sends += [tr.broadcast(t.to(wire), root=me, group=tr.pair(me, dst),
                                       kind="weights", async_op=True, account=False)
                          for t in pieces(e - j * e_loc)]
                continue
            got = (pieces(e - j * e_loc) if owner == me else
                   (tr.broadcast(None, root=owner, group=tr.pair(owner, me),
                                 kind="weights",
                                 like=torch.empty(t.shape, dtype=t.dtype,
                                                  device=wire)).wait()
                    for t in pieces(0)))
            it = iter(got)
            for placed in self.layers_expert_placed:
                for k in EXPERT_KEYS:
                    placed[k][slot - j * S].copy_(next(it))
                    moved.append(placed[k][slot - j * S])
        for hop in sends:
            hop.wait()
        self.transport.regather_weights(moved)
