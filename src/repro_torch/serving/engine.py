"""Continuous-batching serving engine (Orca-style iteration-level
scheduling): between decode iterations finished requests leave the batch
and waiting requests are prefilled inline into the freed KV rows.

The decode iteration runs under one of three runtimes
(``ServingConfig.runtime``):
  * ``monolithic`` — one batched ``models.transformer.decode_step`` over
    every KV row (decode attention on its CUDA kernel; the MoE layer in
    plain torch).  The token-parity oracle of the other two.
  * ``disagg`` — the same monolithic engine whose decode step is a
    ``core.disagg.DisaggregatedInstance``'s ``decode_step``: the whole
    batch split into the runtime plan's m micro-batches.
  * ``pingpong`` — the paper's runtime: the KV rows are split into m
    contiguous micro-batch groups and a ``DisaggregatedInstance`` runs
    each iteration through the ping-pong schedule on two CUDA streams,
    with all three kernels.

With a runtime and ``expert_rebalance_every`` > 0 the engine also
re-solves the expert placement (paper §6) from the runtime's live
routing counts every that many decode iterations, over a sliding window
of the last ``expert_window`` intervals, and applies it to the runtime.

Prefill runs inline on the decode side, or, the paper's §3 split, on a
prefill cluster: with a ``prefill_worker`` (``serving.prefill``) waiting
requests are prefilled on the worker's stream and admission takes
completed results from its transfer queue, moving each request's KV
over the transport (``kvcache.migrate_kv``, or one hop per non-shared
page with ``migrate_pages``).  Admission order equals submission order
on both paths, so under greedy sampling the tokens are identical.

The KV cache has one of two layouts (``ServingConfig.kv_layout``):
  * ``contiguous`` — one dense ``(B, W)`` ring-buffer row per KV slot;
  * ``paged`` — rows are virtual: per-request block tables over a
    refcounted page pool (``serving.pages``) with radix prefix reuse
    (``serving.prefix_cache``).  Each decode iteration gathers the dense
    view through the block tables, runs the unchanged decode step on it,
    and scatters each row's one new token back into its page, so paged
    decode is token-identical to contiguous.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.load_balance import balance_experts, evaluate_placement
from repro_torch.core.transport import InProcessTransport
from repro_torch.device import resolve_device
from repro_torch.kernels.cuda_build import launch_counts
from repro_torch.models.stubs import extra_inputs
from repro_torch.models.transformer import decode_step, init_cache, prefill
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.kvcache import (MicrobatchSlotAllocator, SlotAllocator,
                                         insert_rows, mb_slot_ranges, migrate_kv,
                                         migrate_pages, reset_row)
from repro_torch.serving.pages import PagePool, n_pages_for
from repro_torch.serving.prefill import suffix_prefill
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import sample, sample_rows
from repro_torch.serving.stats import STATS_SCHEMA_VERSION, EngineStats


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
                 config: Optional[ServingConfig] = None, runtime=None,
                 transport=None, prefill_worker=None):
        """``config`` sets every scalar knob (``ServingConfig``; its
        ``runtime`` field picks the mode, its ``device`` field where the
        params live and the KV cache is made, its ``transfer`` field
        whether the host waits for each KV hop).  ``runtime``: the
        ``DisaggregatedInstance`` the disagg and pingpong runtimes drive.
        ``transport``: the hop ledger ``stats()`` reports; by default
        the runtime's (its M2N / N2M / weight hops), else a private
        ``InProcessTransport``.  ``prefill_worker``: a
        ``serving.prefill.PrefillWorker`` that prefills on its own
        stream (the prefill cluster); without one prefill runs inline."""
        base = config if config is not None else ServingConfig(max_batch=8,
                                                               max_seq=256)
        self.device = resolve_device(base.device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        if (prefill_worker is not None
                and prefill_worker.device.type != self.device.type):
            raise ValueError(f"prefill worker runs on {prefill_worker.device}, "
                             f"engine device is {self.device}")
        if base.runtime in ("disagg", "pingpong") and runtime is None:
            raise ValueError(f"{base.runtime} mode needs a "
                             f"DisaggregatedInstance runtime")
        if base.expert_rebalance_every:
            if (base.runtime == "monolithic"
                    or not hasattr(runtime, "apply_placement")):
                raise ValueError("expert_rebalance_every needs a runtime with "
                                 "live placement support (disagg or pingpong, "
                                 "core.disagg.DisaggregatedInstance)")
            if cfg.moe is None:
                raise ValueError("expert rebalancing needs an MoE config")
            if runtime.plan.capacity_mode != "full":
                # fail here, not at the first rebalance mid-serve
                raise ValueError("expert rebalancing requires the runtime "
                                 "plan's capacity_mode='full' (drop-free)")
        self.serving_config = base
        self.cfg = cfg
        self.params = params
        self.mode = base.engine_mode
        self.runtime = runtime if base.runtime != "monolithic" else None
        if transport is None:
            transport = getattr(self.runtime, "transport", None)
        self.transport = (transport if transport is not None
                          else InProcessTransport())
        self.max_batch, self.max_seq = base.max_batch, base.max_seq
        self.sampling = base.sampling_params()
        self.kv_layout = base.kv_layout
        if self.kv_layout == "paged":
            self.page_pool = PagePool(
                cfg, n_pages=base.n_pool_pages, page_size=base.page_size,
                max_seq=self.max_seq, dtype=params["embed"].dtype,
                device=self.device)
            self.prefix = (PrefixCache(self.page_pool) if base.prefix_cache
                           else None)
            self.cache = None           # gathered from the pool per step
            self.block_tables: Dict[int, List[int]] = {}   # rid -> pages
            self._page_reserve: Dict[int, int] = {}        # rid -> unspent
        else:
            self.page_pool = None
            self.prefix = None
            self.cache = init_cache(cfg, self.max_batch, self.max_seq,
                                    dtype=params["embed"].dtype,
                                    device=self.device)
        # the paged prefill worker shares the engine's pool and prefix tree
        if self.page_pool is not None and prefill_worker is not None \
                and prefill_worker.page_size:
            if prefill_worker.page_pool is None:
                prefill_worker.page_pool = self.page_pool
            if prefill_worker.prefix_cache is None and self.prefix is not None:
                prefill_worker.prefix_cache = self.prefix
        self.prefill_worker = prefill_worker
        self.transfer = base.transfer
        if self.mode == "pingpong":
            self.mb_slices = mb_slot_ranges(self.max_batch,
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
        # live expert load balancing (paper §6)
        self.expert_rebalance_every = base.expert_rebalance_every
        self.expert_replication = base.expert_replication
        self._load_window: deque = deque(maxlen=max(1, base.expert_window))
        self.n_rebalances = 0
        self.n_placement_updates = 0
        self.t_rebalance = 0.0

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

    def _extras(self) -> dict:
        """The modality stubs of one request (``models.stubs``): patch
        embeddings (vision) or frames (audio), {} for text models."""
        return extra_inputs(self.cfg, 1, dtype=self.params["embed"].dtype,
                            device=self.device)

    # --------------------------------------------------------- paged helpers
    def _pages_for_request(self, req: Request) -> int:
        """Worst-case pages a request can ever touch: its prompt plus all
        generated tokens, clamped at the ring width (wrapped writes land
        in pages it owns, or fork shared ones, which the clamp covers
        since every logical page is counted)."""
        n_slots = min(self.max_seq, len(req.prompt) + req.max_new_tokens)
        return n_pages_for(n_slots, self.page_pool.page_size)

    def _reserve_pages(self, rid: int, n: int) -> bool:
        """OOM-safe admission: reserve the request's worst case up front,
        evicting cold prefix-cache pages if the free list is short.  On
        False the request stays waiting at the head of the queue."""
        if not self.page_pool.reserve(n):
            if self.prefix is None:
                return False
            self.prefix.evict(n - self.page_pool.available)
            if not self.page_pool.reserve(n):
                return False
        self._page_reserve[rid] = n
        return True

    def _take_page(self, rid: int) -> int:
        """Allocate one page against the request's reservation."""
        left = self._page_reserve.get(rid, 0)
        if left > 0:
            self._page_reserve[rid] = left - 1
            return self.page_pool.alloc(from_reserve=True)
        return self.page_pool.alloc()

    def _fork_page(self, rid: int, page: int) -> int:
        """Copy-on-write a shared page, spending reservation if any."""
        left = self._page_reserve.get(rid, 0)
        if left > 0:
            self._page_reserve[rid] = left - 1
            return self.page_pool.fork(page, from_reserve=True)
        return self.page_pool.fork(page)

    def _install_pages(self, req: Request, shared: List[int],
                       fresh: List[int]):
        """The block table owns one reference per page (the lookup pin of
        a shared page, the alloc reference of a fresh one); the prompt's
        full pages are published to the radix tree."""
        table = list(shared) + list(fresh)
        self.block_tables[req.rid] = table
        if self.prefix is not None:
            self.prefix.insert(req.prompt, table)

    def _admit_paged(self):
        """Inline paged admission (FIFO): prefix-aware prefill straight
        into freshly allocated pages.  A radix hit gathers the shared
        pages and computes only the suffix."""
        ps = self.page_pool.page_size
        while self.waiting and self.slots.free:
            req = self.waiting[0]
            h, shared = (self.prefix.lookup(req.prompt)
                         if self.prefix is not None else (0, []))
            needed = self._pages_for_request(req) - len(shared)
            if not self._reserve_pages(req.rid, needed):
                for p in shared:        # drop the lookup pins
                    self.page_pool.release(p)
                break
            self.waiting.pop(0)
            slot = self.slots.alloc(req.rid)
            t0 = time.perf_counter()
            if h:
                row = self.page_pool.gather_row(shared)
                last_logits, row = suffix_prefill(self.params, self.cfg,
                                                  req.prompt, row, h)
            else:
                toks = torch.tensor([req.prompt], dtype=torch.int64,
                                    device=self.device)
                last_logits, row = prefill(self.params, self.cfg, toks,
                                           max_seq=self.max_seq,
                                           **self._extras())
            self.t_prefill += time.perf_counter() - t0
            t0 = time.perf_counter()
            n_written = n_pages_for(len(req.prompt), ps)
            fresh = [self._take_page(req.rid)
                     for _ in range(n_written - len(shared))]
            if fresh:
                self.page_pool.write_row_span(fresh, row, len(shared) * ps,
                                              len(req.prompt))
            self.t_transfer += time.perf_counter() - t0
            self.n_transfers += 1
            self._install_pages(req, shared, fresh)
            self._start_request(req, slot, last_logits)

    def _hop_streams(self):
        """(source, destination) streams of a KV hop: the worker's and
        the engine's current one on the card, (None, None) on the CPU."""
        if self.device.type != "cuda":
            return None, None
        return (self.prefill_worker.stream,
                torch.cuda.current_stream(self.device))

    def _pump_worker(self):
        """Feed the prefill worker the whole waiting queue (queueing is
        free: no KV exists until a batch is pumped), then run prefill
        batches with bounded work-ahead: at most one batch width of ready
        results past the free rows, so a burst cannot pile up KV on the
        prefill side (more is pumped as rows free up each step)."""
        w = self.prefill_worker
        while self.waiting:
            w.submit(self.waiting.pop(0))
        lookahead = len(self.slots.free) + self.max_batch
        while w.pending_count and w.ready_count < lookahead:
            w.pump(max_batches=1)

    def _admit_from_transfer_queue(self):
        """Disaggregated prefill (paper §3): admit completed prefills
        from the worker's transfer queue into free KV rows, each
        request's KV moved over the transport as one "kv" hop."""
        w = self.prefill_worker
        self._pump_worker()
        src, dst = self._hop_streams()
        while self.slots.free and w.ready_count:
            res = w.pop()
            req = res.request
            slot = self.slots.alloc(req.rid)
            t0 = time.perf_counter()
            migrate_kv(self.cache, res.kv, slot, src=src, dst=dst,
                       sync=self.transfer == "sync", transport=self.transport)
            self.t_transfer += time.perf_counter() - t0
            self.n_transfers += 1
            self._start_request(req, slot, res.last_logits)

    def _admit_paged_from_transfer_queue(self):
        """Disaggregated paged admission: the worker emits per-page
        chunks, and only the non-shared pages cross to the decode side
        (``kvcache.migrate_pages``, one "kv" hop per page).  A result
        whose pages cannot be reserved goes back to the head of the
        queue (FIFO order is part of the parity contract)."""
        w = self.prefill_worker
        self._pump_worker()
        src, dst = self._hop_streams()
        while self.slots.free and w.ready_count:
            res = w.pop()
            req = res.request
            shared = list(res.shared_pages)
            needed = self._pages_for_request(req) - len(shared)
            if not self._reserve_pages(req.rid, needed):
                w.ready.appendleft(res)
                break
            slot = self.slots.alloc(req.rid)
            fresh = [self._take_page(req.rid)
                     for _ in range(len(res.page_chunks))]
            t0 = time.perf_counter()
            migrate_pages(self.page_pool, res.page_chunks, fresh, src=src,
                          dst=dst, sync=self.transfer == "sync",
                          transport=self.transport)
            self.t_transfer += time.perf_counter() - t0
            self.n_transfers += 1
            self._install_pages(req, shared, fresh)
            self._start_request(req, slot, res.last_logits)

    def _admit(self):
        """Prefill of waiting requests into free KV rows (FIFO): inline,
        or from the prefill worker's transfer queue."""
        if self.kv_layout == "paged":
            if self.prefill_worker is not None:
                self._admit_paged_from_transfer_queue()
            else:
                self._admit_paged()
            return
        if self.prefill_worker is not None:
            self._admit_from_transfer_queue()
            return
        while self.waiting and self.slots.free:
            req = self.waiting.pop(0)
            slot = self.slots.alloc(req.rid)
            toks = torch.tensor([req.prompt], dtype=torch.int64,
                                device=self.device)
            extras = self._extras()
            t0 = time.perf_counter()
            last_logits, rcache = prefill(self.params, self.cfg, toks,
                                          max_seq=self.max_seq, **extras)
            self.t_prefill += time.perf_counter() - t0
            t0 = time.perf_counter()
            insert_rows(self.cache, rcache, slot)
            self.t_transfer += time.perf_counter() - t0
            self.n_transfers += 1
            self._start_request(req, slot, last_logits)

    def _rebalance(self):
        """Drain one interval of live routing counts, re-solve the
        placement over the sliding window, and apply it (§6)."""
        t0 = time.perf_counter()
        self._load_window.append(self.runtime.take_expert_counts())
        loads = np.sum(self._load_window, axis=0)
        placement = balance_experts(loads, self.runtime.n_expert_nodes,
                                    allow_replication=self.expert_replication)
        if self.runtime.apply_placement(placement):
            self.n_placement_updates += 1
        self.n_rebalances += 1
        self.t_rebalance += time.perf_counter() - t0

    def _retire(self):
        for rid in [r for r, q in self.running.items() if q.done]:
            req = self.running.pop(rid)
            req.t_done = time.perf_counter()
            slot = self.slots.release(rid)
            if self.kv_layout == "paged":
                # drop the table's references: pages the radix tree (or
                # another request) still holds stay alive.  A recycled
                # page is invalidated (pos = -1) when it is allocated.
                for p in self.block_tables.pop(rid):
                    self.page_pool.release(p)
                left = self._page_reserve.pop(rid, 0)
                if left:
                    self.page_pool.unreserve(left)
            else:
                # a recycled row must never expose the previous request's KV
                reset_row(self.cache, slot)
            self.finished.append(req)

    def _paged_writeback(self, dense_cache: List[dict]):
        """Scatter this iteration's new KV token of each live row back
        into its physical page.  The decode step wrote it at ring slot
        ``(position - 1) % W`` of the gathered view; the page holding that
        slot is taken from the request's reservation when the row grows
        into it, and forked first if it is shared (the ring's wrap is the
        one legal write into a prefix-cache or multi-holder page)."""
        pool, ps = self.page_pool, self.page_pool.page_size
        rows, slots, pages, offs = [], [], [], []
        for req in self.running.values():
            w = (req.position - 1) % self.max_seq
            lp = w // ps
            tb = self.block_tables[req.rid]
            if lp == len(tb):
                tb.append(self._take_page(req.rid))
            elif pool.is_shared(tb[lp]):
                tb[lp] = self._fork_page(req.rid, tb[lp])
            rows.append(req.slot)
            slots.append(w)
            pages.append(tb[lp])
            offs.append(w % ps)
        pool.write_tokens(dense_cache, np.asarray(rows), np.asarray(slots),
                          np.asarray(pages), np.asarray(offs))

    def block_table_array(self) -> np.ndarray:
        """The (max_batch, n_logical) int32 block tables of the running
        requests by KV row, -1 where unmapped."""
        bt = np.full((self.max_batch, self.page_pool.n_logical), -1, np.int32)
        for req in self.running.values():
            tb = self.block_tables[req.rid]
            bt[req.slot, :len(tb)] = tb
        return bt

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
        if self.kv_layout == "paged":
            # block-table gather: a fresh dense (B, W) view, a pure copy
            # (unmapped pages read pos = -1, exactly a reset row), so the
            # decode step below is the contiguous layout's, bit for bit
            cache = self.page_pool.gather(self.block_table_array())
        else:
            cache = self.cache
        if self.runtime is not None:
            # idle rows decode anyway; keep them out of the expert counts
            self.runtime.set_active_slots(active)
        if self.mode == "pingpong":
            logits, cache = self.runtime.decode_microbatched(
                toks, cache, pos_t, self.mb_slices)
        elif self.runtime is not None:                           # disagg
            logits, cache = self.runtime.decode_step(toks, cache, pos_t)
        else:
            logits, cache = decode_step(self.params, self.cfg, toks, cache,
                                        pos_t)
        if self.kv_layout == "paged":
            # the attention stages wrote the new tokens into the gathered
            # view on the caller's current stream (the runtime's attention
            # stream), and the write-back is issued on that stream after
            # them, so stream order alone puts it after the last write
            self._paged_writeback(cache)
        nxt = sample_rows(logits, self._next_seed(), rids,
                          self.sampling).tolist()
        self.t_decode += time.perf_counter() - t0
        for req in self.running.values():
            req.generated.append(nxt[req.slot])
            self._last_token[req.slot] = nxt[req.slot]
        self.n_decode_iters += 1
        if (self.expert_rebalance_every
                and self.n_decode_iters % self.expert_rebalance_every == 0):
            self._rebalance()
        n_active = len(self.running)
        self._retire()
        return n_active

    @property
    def outstanding(self) -> bool:
        """Any request not yet finished: waiting, running, or still in
        the prefill worker's queues."""
        w = self.prefill_worker
        backlog = w is not None and (w.pending_count or w.ready_count)
        return bool(self.waiting or self.running or backlog)

    def run_until_done(self, max_iters: int = 10_000):
        while self.outstanding and max_iters:
            self.step()
            max_iters -= 1
        return self.finished

    # ------------------------------------------------------------- metrics
    def stats(self) -> EngineStats:
        """The JAX engine's payload (``serving.stats``, schema v4):
        tokens, iterations, per-phase host time (decode includes the wait
        for the sampled tokens; with a prefill worker its own counters),
        the transport ledger, per-stage device time (pingpong) and the
        expert-balance report (with a runtime); plus the port's card name
        and kernel launch counts.  ``use_kernels`` is true exactly on the
        card: there the decode paths launch the CUDA kernels."""
        lat = [r.t_done - r.t_submit for r in self.finished]
        phases = {"transfer_s": self.t_transfer,
                  "transfer_n": self.n_transfers,
                  "transfer_mode": self.transfer,
                  "decode_s": self.t_decode,
                  "decode_n": self.n_decode_iters}
        if self.prefill_worker is not None:
            phases.update(self.prefill_worker.stats())
        else:
            phases.update(prefill_s=self.t_prefill, prefills=self.n_prefills)
        out = {
            "schema_version": STATS_SCHEMA_VERSION,
            "finished": len(self.finished),
            "tokens": sum(len(r.generated) for r in self.finished),
            "decode_iters": self.n_decode_iters,
            "prefills": self.n_prefills,
            "mean_latency_s": sum(lat) / len(lat) if lat else 0.0,
            "mode": self.mode,
            "use_kernels": self.device.type == "cuda",
            "disagg_prefill": self.prefill_worker is not None,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "phases": phases,
            "kernel_launches": launch_counts(),
            "kv_layout": self.kv_layout,
            # per-hop traffic by kind (tokens / weights / collective), the
            # ledger shared with the runtime
            "transport": self.transport.stats(),
        }
        if self.page_pool is not None:
            out["kv_pages"] = self.page_pool.stats()
        if self.prefix is not None:
            out["prefix_cache"] = self.prefix.stats()
        if self.mode == "pingpong":
            out["n_microbatches"] = len(self.mb_slices)
            out["stages"] = self.runtime.stage_report()
        if self.cfg.moe is not None and self.runtime is not None:
            # the placement served now, priced on the latest traffic
            # window (intervals drained at rebalances plus the remainder;
            # also the never-rebalanced static case)
            loads = (np.sum(self._load_window, axis=0)
                     if self._load_window else 0.0)
            loads = loads + self.runtime.peek_expert_counts()
            fractions = self.runtime.placement_fractions
            pl = evaluate_placement(fractions, loads)
            out["imbalance"] = pl.imbalance
            out["expert_node_cost"] = pl.node_cost.tolist()
            out["expert_loads"] = loads.tolist()
            out["rebalances"] = self.n_rebalances
            out["placement_updates"] = self.n_placement_updates
            out["rebalance_s"] = self.t_rebalance
            out["replicated_experts"] = int(
                ((fractions > 1e-9).sum(axis=1) > 1).sum())
        return out
