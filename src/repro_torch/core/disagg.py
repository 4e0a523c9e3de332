"""Disaggregated expert parallelism runtime (paper §3-§4) on one card.

The JAX package places the attention stage and the expert stage on two
disjoint device meshes and gets their overlap from async dispatch.  On
one H100 the two stages run on two CUDA streams instead:

  * the attention stream (the caller's current stream) runs attention,
    the fused router/top-k/dispatch kernel and the combine;
  * the expert stream runs the grouped expert MLP;
  * the M2N hop is an event recorded on the attention stream that the
    expert stream waits on, the N2M hop the reverse.

Work is issued in the order of ``pingpong.build_schedule``, double
buffered: after attn(mb) and expert(mb) are issued, the previous
micro-batch's return hop and combine are issued, so while the expert
stream computes expert(mb) the attention stream computes attn(mb+1).
A tensor made on one stream and read on the other is marked with
``record_stream`` so the caching allocator does not hand its memory out
again before the reader is done.

On the CPU (``device="cpu"`` parameters) there are no streams and the
same schedule runs in order; the kernels take their plain versions.

Per-micro-batch cache rows are views of the engine's cache, and the
attention sublayer writes the new K/V token into them in place, so no
cache merge follows the step (the JAX runtime rebuilt the cache).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from repro_torch.config import SUPPORTED_KINDS, ModelConfig
from repro_torch.core import pingpong
from repro_torch.kernels import ops as kops
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import rms_norm
from repro_torch.models.ffn import gated_ffn
from repro_torch.models.transformer import (embed_tokens, lm_head,
                                            self_attn_decode_sublayer)

EXPERT_KEYS = ("we1", "we3", "we2")
DENSE_KEYS = ("w1", "w3", "w2")
# pipeline stages timed by the runtime (the M2N/N2M hops are event waits
# between streams on one card, and take no time of their own)
STAGES = ("attn", "expert", "combine")


@dataclass
class DisaggPlan:
    n_microbatches: int = 3
    capacity_mode: str = "full"


class DisaggregatedInstance:
    """One model replica served with disaggregated expert parallelism."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 plan: Optional[DisaggPlan] = None):
        for kind in cfg.layer_kinds:
            if kind not in SUPPORTED_KINDS:
                raise NotImplementedError(
                    f"disaggregated runtime does not support layer kind "
                    f"{kind!r} ({cfg.name})")
        self.cfg = cfg
        self.plan = plan if plan is not None else DisaggPlan()
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
        self.expert_counts = torch.zeros(E, dtype=torch.float32,
                                         device=self.device)
        self._active: Optional[torch.Tensor] = None
        self.reset_stage_times()
        self.last_trace: List[tuple] = []

    # ------------------------------------------------------------ stages
    def _attn_phase(self, p, x, act, cache, pos, window):
        cfg = self.cfg
        x = x + self_attn_decode_sublayer(p, cfg, x, pos, cache, window)
        h = rms_norm(x, p["ln2"])
        if cfg.moe is None:
            return x, h, None
        cap = moe_lib.expert_capacity(h.shape[0], cfg.moe,
                                      self.plan.capacity_mode)
        # fused router + top-k + capacity dispatch; act (the live-row
        # weights) keeps idle KV rows out of the traffic counts
        idx_buf, gate_buf, counts = kops.gating_dispatch(
            h, p["router"], cfg.moe.top_k, n_buckets=cfg.moe.n_experts,
            capacity=cap, bias=p.get("router_bias"), count_weights=act)
        xe = moe_lib.gather_tokens(h, idx_buf)                 # (E, C, d)
        return x, h, {"xe": xe, "idx": idx_buf, "gates": gate_buf,
                      "counts": counts}

    def _expert_phase(self, pe, payload):
        if self.cfg.moe is not None:
            return kops.grouped_mlp(payload, pe["we1"], pe["we3"], pe["we2"],
                                    self.cfg.act)
        return gated_ffn(payload, pe["w1"], pe["w3"], pe["w2"], self.cfg.act)

    def _combine_phase(self, p, x, h, out, disp):
        cfg = self.cfg
        if cfg.moe is not None:
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
        self.n_hops = 0
        self._pending_events = []

    def _timed(self, stage: str, stream, fn, *args):
        """Run one stage on ``stream``.  On the card its device time is
        taken with CUDA events (read lazily by ``stage_report``, so the
        pipeline never blocks); on the CPU with the host clock."""
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
        self._pending_events.append((stage, start, end))
        return out

    def stage_report(self) -> dict:
        """Cumulative per-stage seconds and counts, plus the per-op
        T_a (attention + combine) and T_e (expert) of the paper."""
        for stage, start, end in self._pending_events:
            end.synchronize()
            self.stage_times[stage] += start.elapsed_time(end) / 1e3
        self._pending_events = []
        rep = {f"{s}_s": self.stage_times[s] for s in STAGES}
        rep.update({f"{s}_n": self.stage_counts[s] for s in STAGES})
        rep["hops"] = self.n_hops
        rep["t_a"] = ((self.stage_times["attn"] + self.stage_times["combine"])
                      / max(1, self.stage_counts["attn"]))
        rep["t_e"] = (self.stage_times["expert"]
                      / max(1, self.stage_counts["expert"]))
        return rep

    # ------------------------------------------------------ stream hops
    def _hop(self, tensor, src, dst):
        """Hand ``tensor`` from stream ``src`` to stream ``dst``: ``dst``
        waits for everything issued on ``src`` so far, and the allocator
        keeps the tensor's memory until ``dst`` is done with it."""
        self.n_hops += 1
        if src is None:
            return
        dst.wait_stream(src)
        tensor.record_stream(dst)

    # ------------------------------------------------------ routing counts
    def set_active_slots(self, active):
        """Mark which KV rows serve a request ((B,) 0/1); idle rows are
        decoded anyway but kept out of the per-expert counts."""
        self._active = torch.as_tensor(active, dtype=torch.float32,
                                       device=self.device)

    # ------------------------------------------------------------ decode
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

        for l, kind in enumerate(cfg.layer_kinds):
            window = cfg.window if kind == "local" else 0
            pa, pe = self.layers_attn[l], self.layers_expert[l]
            inflight: deque = deque()

            def drain_one():
                i, x, h, out, disp = inflight.popleft()
                self._hop(out, exp_s, attn_s)                    # N2M
                xs[i] = self._timed("combine", attn_s, self._combine_phase,
                                    pa, x, h, out, disp)

            for i, s in enumerate(mbs):
                entry = {k: v[s] for k, v in cache[l].items()}   # row views
                x, h, disp = self._timed("attn", attn_s, self._attn_phase,
                                         pa, xs[i], acts[i], entry, poss[i],
                                         window)
                if disp is not None:
                    self.expert_counts += disp["counts"]
                trace.append(("attn", i, l))
                payload = h if disp is None else disp["xe"]
                self._hop(payload, attn_s, exp_s)                # M2N
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
