"""Continuous-batching serving engine (Orca-style iteration-level
scheduling): between decode iterations finished requests leave the batch
and waiting requests are prefilled inline into the freed KV rows.

The decode iteration runs in one of two modes:
  * ``monolithic`` — one batched ``models.transformer.decode_step`` over
    every KV row (decode attention on its CUDA kernel; the MoE layer in
    plain torch).  The token-parity oracle of the ping-pong mode.
  * ``pingpong`` — the paper's runtime: the KV rows are split into m
    contiguous micro-batch groups and a ``core.disagg``
    ``DisaggregatedInstance`` runs each iteration through the ping-pong
    schedule on two CUDA streams, with all three kernels.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.pingpong import even_partition
from repro_torch.device import resolve_device
from repro_torch.kernels.cuda_build import launch_counts
from repro_torch.models.transformer import decode_step, init_cache, prefill
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.kvcache import (MicrobatchSlotAllocator, SlotAllocator,
                                         insert_rows, reset_row)
from repro_torch.serving.sampler import sample, sample_rows


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    t_submit: float = 0.0
    t_done: float = 0.0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def position(self) -> int:
        return len(self.prompt) + len(self.generated)


class Engine:
    def __init__(self, cfg: ModelConfig, params: dict, *,
                 config: Optional[ServingConfig] = None, runtime=None):
        """``config`` sets every scalar knob (``ServingConfig``; its
        ``runtime`` field picks the mode, its ``device`` field where the
        params live and the KV cache is made).  ``runtime``: the
        ``DisaggregatedInstance`` the pingpong mode drives."""
        base = config if config is not None else ServingConfig(max_batch=8,
                                                               max_seq=256)
        self.device = resolve_device(base.device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        if base.runtime == "pingpong" and runtime is None:
            raise ValueError("pingpong mode needs a DisaggregatedInstance "
                             "runtime")
        self.serving_config = base
        self.cfg = cfg
        self.params = params
        self.mode = base.runtime
        self.runtime = runtime if self.mode == "pingpong" else None
        self.max_batch, self.max_seq = base.max_batch, base.max_seq
        self.sampling = base.sampling_params()
        self.cache = init_cache(cfg, self.max_batch, self.max_seq,
                                dtype=params["embed"].dtype, device=self.device)
        if self.mode == "pingpong":
            self.mb_slices = even_partition(self.max_batch,
                                            runtime.plan.n_microbatches)
            self.slots = MicrobatchSlotAllocator(self.max_batch, self.mb_slices)
        else:
            self.mb_slices = None
            self.slots = SlotAllocator(self.max_batch)
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}
        self.finished: List[Request] = []
        # host-side seed stream: one draw per sampling event
        self._seeds = torch.Generator().manual_seed(base.seed)
        self._last_token = [0] * self.max_batch
        self.n_decode_iters = 0
        self.n_prefills = 0
        self.t_prefill = 0.0
        self.t_transfer = 0.0
        self.t_decode = 0.0
        self.n_transfers = 0

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.waiting.append(req)

    # ------------------------------------------------------------- schedule
    def _next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._seeds))

    def _start_request(self, req: Request, slot: int, last_logits):
        req.slot = slot
        tok = int(sample(last_logits, self._next_seed(), self.sampling)[0])
        req.generated.append(tok)
        self._last_token[slot] = tok
        self.running[req.rid] = req
        self.n_prefills += 1

    def _admit(self):
        """Inline prefill of waiting requests into free KV rows (FIFO)."""
        while self.waiting and self.slots.free:
            req = self.waiting.pop(0)
            slot = self.slots.alloc(req.rid)
            toks = torch.tensor([req.prompt], dtype=torch.int64,
                                device=self.device)
            t0 = time.perf_counter()
            last_logits, rcache = prefill(self.params, self.cfg, toks,
                                          max_seq=self.max_seq)
            self.t_prefill += time.perf_counter() - t0
            t0 = time.perf_counter()
            insert_rows(self.cache, rcache, slot)
            self.t_transfer += time.perf_counter() - t0
            self.n_transfers += 1
            self._start_request(req, slot, last_logits)

    def _retire(self):
        for rid in [r for r, q in self.running.items() if q.done]:
            req = self.running.pop(rid)
            req.t_done = time.perf_counter()
            slot = self.slots.release(rid)
            # a recycled row must never expose the previous request's KV
            reset_row(self.cache, slot)
            self.finished.append(req)

    # ----------------------------------------------------------------- step
    def step(self) -> int:
        """One engine iteration: admit + one decode step.  Returns the
        number of requests decoded."""
        self._retire()
        self._admit()
        if not self.running:
            return 0
        pos = np.zeros((self.max_batch,), np.int32)
        rids = np.zeros((self.max_batch,), np.int64)
        active = np.zeros((self.max_batch,), np.float32)
        for req in self.running.values():
            pos[req.slot] = req.position - 1
            rids[req.slot] = req.rid
            active[req.slot] = 1.0
        toks = torch.tensor(self._last_token, dtype=torch.int64,
                            device=self.device)
        pos_t = torch.from_numpy(pos).to(self.device)
        t0 = time.perf_counter()
        if self.mode == "pingpong":
            # idle rows decode anyway; keep them out of the expert counts
            self.runtime.set_active_slots(active)
            logits, self.cache = self.runtime.decode_microbatched(
                toks, self.cache, pos_t, self.mb_slices)
        else:
            logits, self.cache = decode_step(self.params, self.cfg, toks,
                                             self.cache, pos_t)
        nxt = sample_rows(logits, self._next_seed(), rids,
                          self.sampling).tolist()
        self.t_decode += time.perf_counter() - t0
        for req in self.running.values():
            req.generated.append(nxt[req.slot])
            self._last_token[req.slot] = nxt[req.slot]
        self.n_decode_iters += 1
        n_active = len(self.running)
        self._retire()
        return n_active

    @property
    def outstanding(self) -> bool:
        return bool(self.waiting or self.running)

    def run_until_done(self, max_iters: int = 10_000):
        while self.outstanding and max_iters:
            self.step()
            max_iters -= 1
        return self.finished

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """Tokens, iterations, per-phase host time (decode includes the
        wait for the sampled tokens), per-stage device time (pingpong)
        and the kernel launch counts."""
        lat = [r.t_done - r.t_submit for r in self.finished]
        out = {
            "finished": len(self.finished),
            "tokens": sum(len(r.generated) for r in self.finished),
            "decode_iters": self.n_decode_iters,
            "prefills": self.n_prefills,
            "mean_latency_s": sum(lat) / len(lat) if lat else 0.0,
            "mode": self.mode,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "phases": {"prefill_s": self.t_prefill, "prefills": self.n_prefills,
                       "transfer_s": self.t_transfer,
                       "transfer_n": self.n_transfers,
                       "decode_s": self.t_decode,
                       "decode_n": self.n_decode_iters},
            "kernel_launches": launch_counts(),
        }
        if self.mode == "pingpong":
            out["n_microbatches"] = len(self.mb_slices)
            out["stages"] = self.runtime.stage_report()
            out["expert_loads"] = self.runtime.expert_counts.tolist()
        return out
