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

Per-micro-batch cache rows are views of the engine's cache, and the
attention sublayer writes the new K/V token into them in place, so no
cache merge follows the step (the JAX runtime rebuilt the cache).
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
from repro_torch.core.transport import InProcessTransport
from repro_torch.kernels import ops as kops
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import rms_norm
from repro_torch.models.ffn import gated_ffn
from repro_torch.models.transformer import (embed_tokens, init_cache, lm_head,
                                            self_attn_decode_sublayer)

EXPERT_KEYS = ("we1", "we3", "we2")
DENSE_KEYS = ("w1", "w3", "w2")
# pipeline stages timed by the runtime (attention compute, M2N dispatch
# hop, expert compute, N2M return hop, attention-side combine)
STAGES = ("attn", "m2n", "expert", "n2m", "combine")


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
        self.device = params["embed"].device
        # the two stages share the caller's parameter tensors (no copy)
        split = EXPERT_KEYS if cfg.moe is not None else DENSE_KEYS
        self.layers_attn = [{k: v for k, v in lp.items() if k not in split}
                            for lp in params["layers"]]
        self.layers_expert = [{k: lp[k] for k in split}
                              for lp in params["layers"]]
        self.head = {k: params[k] for k in ("embed", "final_norm", "lm_head")
                     if k in params}
        self.expert_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
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
        idx_buf, gate_buf, counts = kops.gating_dispatch(
            h, p["router"], cfg.moe.top_k, n_buckets=n_buckets,
            capacity=cap, bias=p.get("router_bias"), count_weights=act,
            slots_per_node=spn, **tk)
        xe = moe_lib.gather_tokens(h, idx_buf)                 # (rows, C, d)
        return x, h, {"xe": xe, "idx": idx_buf, "gates": gate_buf,
                      "counts": counts}

    def _expert_phase(self, pe, payload):
        if self.cfg.moe is not None:
            return kops.grouped_mlp(payload, pe["we1"], pe["we3"], pe["we2"],
                                    self.cfg.act)
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
        self.stage_times = {s: 0.0 for s in STAGES}
        self.stage_counts = {s: 0 for s in STAGES}
        self._pending_events = []

    def _timed(self, stage: str, stream, fn, *args):
        """Run one stage on ``stream``.  On the card its device time is
        taken with CUDA events (read lazily by ``stage_report``, so the
        pipeline never blocks, unless ``plan.profile_stages``); on the
        CPU with the host clock."""
        self.stage_counts[stage] += 1
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
        hop), and the port's count of stream hops.

        T_c differs in origin from the JAX runtime's: there it is the
        host wall time of a cross-mesh ``device_put``, which has no
        counterpart on one card.  Here a hop is a stream wait, so its
        seconds are what the transport prices it at: 0 under
        ``inproc``, the ``RdmaCostModel`` latency under ``simrdma``."""
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
        return rep

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
        cache = init_cache(cfg, batch, max_seq, dtype=self.head["embed"].dtype,
                           device=self.device)
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
        priced latency."""
        h = self.transport.send_tokens(payload, dst, src=src, fanout=fanout)
        self.stage_counts[stage] += 1
        self.stage_times[stage] += h.sim_s
        if dst is not None:
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
        self._slot_experts = src
        # the regather is the "weights" hop of the ledger
        self.transport.regather_weights(moved)
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
        for the attention stream)."""
        return self.expert_counts.double().cpu().numpy()

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
        attn_s = (torch.cuda.current_stream(self.device)
                  if self.expert_stream is not None else None)
        exp_s = self.expert_stream
        trace = []
        xs = [embed_tokens(self.head, cfg, tokens[s]) for s in mbs]
        poss = [pos[s] for s in mbs]
        act = (self._active if self._active is not None else
               torch.ones(B, dtype=torch.float32, device=self.device))
        acts = [act[s] for s in mbs]
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
                xs[i] = self._timed("combine", attn_s, self._combine_phase,
                                    pa, x, h, out, disp)

            for i, s in enumerate(mbs):
                entry = {k: v[s] for k, v in cache[l].items()}   # row views
                x, h, disp = self._timed("attn", attn_s, self._attn_phase,
                                         pa, xs[i], acts[i], entry, poss[i],
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
                    payload = h if disp is None else disp["xe"]
                    self._hop("m2n", payload, attn_s, exp_s)
                    out = self._timed("expert", exp_s, self._expert_phase, pe,
                                      payload)
                trace.append(("expert", i, l))
                inflight.append((i, x, h, out, disp))
                # double buffer: one micro-batch on the expert stream, one
                # returning and combining on the attention stream
                if len(inflight) > 1:
                    drain_one()
            while inflight:
                drain_one()

        logits = torch.cat([lm_head(self.head, cfg, x) for x in xs], 0)
        self.last_trace = trace
        return logits, cache
