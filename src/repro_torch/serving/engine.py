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

Across ranks (a ``MultiControllerTransport`` with a serving layout,
``setup_serving``) every rank runs this host loop, the multi-controller
model of the JAX launcher: the same queues, slots, page tables and
prefix tree everywhere.  The first attention rank decides each step's
admissions and broadcasts them before any hop; every rank admits the
same requests (a rank whose own view differs fails the step).  An
attention rank holds the KV rows of its micro-batches (with paged KV a
replica of the page pool, as the prefill ranks do), an expert rank none:
it runs only its stage.  Prefill runs inline on the attention ranks, or
on the prefill ranks' workers, each request's KV moved to its attention
rank as a "kv" hop.  The first tokens and each step's sampled tokens are
made where the logits are and summed into every rank's copy.
``stats()`` merges every rank's figures, so each reads the same.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.disagg import microbatch_owners
from repro_torch.core.load_balance import balance_experts, evaluate_placement
from repro_torch.core.transport import InProcessTransport, _leaves as _tensors
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


def _check_rank_layout(roles, sc: ServingConfig, runtime):
    """Refuse, on every rank alike, a configuration the layout of ranks
    cannot serve."""
    if sc.runtime == "monolithic" or runtime is None:
        raise ValueError("across ranks the engine serves the disaggregated "
                         "runtimes (disagg or pingpong); monolithic runs in one "
                         "process")
    if roles.prefill and not roles.separate_prefill:
        raise ValueError(f"{sc.prefill_devices} prefill ranks leave no decode "
                         f"rank of {roles.world}")
    if len(roles.prefill) != sc.prefill_devices:
        raise ValueError(f"the layout {roles} has {len(roles.prefill)} prefill "
                         f"ranks, the config {sc.prefill_devices}")


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
        self.transport = (transport if transport is not None else getattr(
            runtime if base.runtime != "monolithic" else None, "transport", None))
        roles = getattr(self.transport, "roles", None)
        self.roles = roles if roles is not None and roles.world > 1 else None
        self.rank = self.transport.process_index if self.roles else 0
        self.role = self.roles.role(self.rank) if self.roles else "attn+expert"
        if self.roles is not None:
            _check_rank_layout(self.roles, base, runtime)
        # an expert rank keeps no embedding: its runtime knows the dtype
        dev, self.dtype = ((params["embed"].device, params["embed"].dtype)
                           if "embed" in params else (runtime.device, runtime.dtype))
        if dev.type != self.device.type:
            raise ValueError(f"params live on {dev}, engine device is {self.device}")
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
        # an expert rank computes only its stage, through the runtime,
        # which drops its static experts from the card once placed
        self.params = params if self.role != "expert" else {}
        self.mode = base.engine_mode
        self.runtime = runtime if base.runtime != "monolithic" else None
        if self.transport is None:
            self.transport = InProcessTransport()
        self.max_batch, self.max_seq = base.max_batch, base.max_seq
        self.sampling = base.sampling_params()
        self.kv_layout = base.kv_layout
        # the KV rows this rank holds: every row in one process, an
        # attention rank's micro-batches across ranks, none elsewhere
        self.rows = slice(0, self.max_batch)
        if self.roles is not None:
            mbs = mb_slot_ranges(self.max_batch, runtime.plan.n_microbatches)
            self.rows = (runtime.attn_rows(mbs) if self.role != "prefill"
                         else None) or slice(0, 0)
        if self.kv_layout == "paged":
            self.page_pool = PagePool(
                cfg, n_pages=base.n_pool_pages, page_size=base.page_size,
                max_seq=self.max_seq, dtype=self.dtype,
                device=self.device, with_store=self.role != "expert")
            self.prefix = (PrefixCache(self.page_pool) if base.prefix_cache
                           else None)
            self.cache = None           # gathered from the pool per step
            self.block_tables: Dict[int, List[int]] = {}   # rid -> pages
            self._page_reserve: Dict[int, int] = {}        # rid -> unspent
        else:
            self.page_pool = None
            self.prefix = None
            n_rows = self.rows.stop - self.rows.start
            self.cache = (init_cache(cfg, n_rows, self.max_seq, dtype=self.dtype,
                                     device=self.device) if n_rows else None)
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

    def _admit(self):
        """Prefill of waiting requests into free KV rows (FIFO): the host
        half (``_admission_plan``: the queues, slots and pages) and then
        the device half (``_admit_records``: inline prefill, or the KV hop
        of each prefill result).  Across ranks the first attention rank
        plans first and broadcasts the requests it admits; every other
        rank admits exactly those (its own plan, held to their count, must
        give the same ones)."""
        if self.roles is None:
            recs = self._admission_plan(None)
        else:
            leader = self.roles.attn[0]
            recs = self._admission_plan(None) if self.rank == leader else None
            said = self.transport.broadcast_ints(
                [len(recs)] + [r[0].rid for r in recs] if recs is not None else [],
                root=leader, n=self.max_batch + 1)
            rids = said[1:1 + said[0]]
            if recs is None:
                recs = self._admission_plan(said[0])
            if [r[0].rid for r in recs] != rids:
                raise RuntimeError(f"rank {self.rank} admits "
                                   f"{[r[0].rid for r in recs]}, the first "
                                   f"attention rank {rids}")
        if recs:
            self._admit_records(recs)

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
            elif self.rows.start <= slot < self.rows.stop:
                # a recycled row must never expose the previous request's KV
                reset_row(self.cache, slot - self.rows.start)
            self.finished.append(req)

    def _paged_writeback(self, dense_cache: List[dict]):
        """Scatter this iteration's new KV token of each live row back
        into its physical page.  The decode step wrote it at ring slot
        ``(position - 1) % W`` of the gathered view; the page holding that
        slot is taken from the request's reservation when the row grows
        into it, and forked first if it is shared (the ring's wrap is the
        one legal write into a prefix-cache or multi-holder page).  Across
        ranks every rank keeps the tables so, and an attention rank writes
        its own rows (``dense_cache`` None: a rank without KV rows)."""
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
            if self.rows.start <= req.slot < self.rows.stop:
                rows.append(req.slot - self.rows.start)
                slots.append(w)
                pages.append(tb[lp])
                offs.append(w % ps)
        if dense_cache is not None:
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
        number of requests decoded.  Across ranks a rank runs its stage of
        the decode step (a prefill rank none), and the tokens sampled
        from an attention rank's rows are summed into every rank's copy."""
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
        t0 = time.perf_counter()
        logits = cache = None
        if self.role != "prefill":
            toks = torch.tensor(self._last_token, dtype=torch.int64,
                                device=self.device)
            pos_t = torch.from_numpy(pos).to(self.device)
            cache = self.cache
            if self.kv_layout == "paged" and self.rows.stop > self.rows.start:
                # block-table gather: a fresh dense (B, W) view, a pure copy
                # (unmapped pages read pos = -1, exactly a reset row), so
                # the decode step below is the contiguous layout's, bit for
                # bit
                cache = self.page_pool.gather(self.block_table_array()[self.rows])
            if self.runtime is not None:
                # idle rows decode anyway; keep them out of the expert counts
                self.runtime.set_active_slots(active)
            if self.mode == "pingpong":
                logits, cache = self.runtime.decode_microbatched(
                    toks, cache, pos_t, self.mb_slices)
            elif self.runtime is not None:                       # disagg
                logits, cache = self.runtime.decode_step(toks, cache, pos_t)
            else:
                logits, cache = decode_step(self.params, self.cfg, toks, cache,
                                            pos_t)
        if self.kv_layout == "paged":
            # the attention stages wrote the new tokens into the gathered
            # view on the caller's current stream (the runtime's attention
            # stream), and the write-back is issued on that stream after
            # them, so stream order alone puts it after the last write
            self._paged_writeback(cache if logits is not None else None)
        seed = self._next_seed()
        if self.roles is None:
            nxt = sample_rows(logits, seed, rids, self.sampling).tolist()
        else:
            nxt = torch.zeros(self.max_batch, dtype=torch.int64,
                              device=self.transport._wire_device())
            if logits is not None:
                nxt[self.rows] = sample_rows(logits, seed, rids[self.rows],
                                             self.sampling).to(nxt.device)
            nxt = self.transport.share(nxt).tolist()
        self.t_decode += time.perf_counter() - t0
        for req in self.running.values():
            req.generated.append(nxt[req.slot])
            self._last_token[req.slot] = nxt[req.slot]
        self.n_decode_iters += 1
        if (self.expert_rebalance_every and self.role != "prefill"
                and self.n_decode_iters % self.expert_rebalance_every == 0):
            self._rebalance()
        n_active = len(self.running)
        self._retire()
        return n_active

    # ------------------------------------------------------------- ranks
    def _owner(self, slot: int) -> int:
        """The attention rank that holds KV row ``slot``."""
        mbs = mb_slot_ranges(self.max_batch, self.runtime.plan.n_microbatches)
        for s, a in zip(mbs, microbatch_owners(self.roles.attn, len(mbs))):
            if s.start <= slot < s.stop:
                return a
        raise ValueError(f"slot {slot} outside the batch")

    def _admission_plan(self, quota: Optional[int]) -> list:
        """The host half of admission (FIFO): pump the prefill worker, then
        take requests (from the waiting queue, or the worker's transfer
        queue) into free KV rows and, paged, reserve their worst case of
        pages (evicting cold prefix pages if short), take the pages their
        prompt fills and publish them to the radix tree, until ``quota``
        (None: as many as fit).  A request whose pages cannot be reserved
        stays at the head of its queue.  Returns
        [(request, slot, prefill result or None, shared pages, fresh
        pages, shared tokens)]."""
        w, paged, recs = self.prefill_worker, self.kv_layout == "paged", []
        if w is not None:
            self._pump_worker()
        while self.slots.free and (quota is None or len(recs) < quota):
            h, shared, res = 0, [], None
            if w is not None:
                if not w.ready_count:
                    break
                res = w.ready[0]
                req, shared = res.request, list(res.shared_pages)
            elif self.waiting:
                req = self.waiting[0]
                if paged and self.prefix is not None:
                    h, shared = self.prefix.lookup(req.prompt)
            else:
                break
            if paged and not self._reserve_pages(
                    req.rid, self._pages_for_request(req) - len(shared)):
                if w is None:
                    for p in shared:            # drop the lookup pins
                        self.page_pool.release(p)
                break
            w.ready.popleft() if w is not None else self.waiting.pop(0)
            slot = self.slots.alloc(req.rid)
            fresh = []
            if paged:
                n = (len(res.page_chunks) if res is not None else
                     n_pages_for(len(req.prompt), self.page_pool.page_size)
                     - len(shared))
                fresh = [self._take_page(req.rid) for _ in range(n)]
                self._install_pages(req, shared, fresh)
            recs.append((req, slot, res, shared, fresh, h))
        if quota is not None and len(recs) != quota:
            raise RuntimeError(f"rank {self.rank} can admit {len(recs)} requests, "
                               f"the first attention rank admitted {quota}")
        return recs

    def _admit_records(self, recs: list):
        """The device half of admission, in order: inline prefill (in one
        process, or across ranks on the attention rank that owns the
        slot; with paged KV every attention rank fills its pool
        replica), or each prefill result's KV hop: in one process from the
        worker's stream (``migrate_kv`` / ``migrate_pages``), across ranks
        from its prefill rank, a row to the attention rank that owns the
        slot, a page to every rank that keeps the pool.  Then each first
        token is sampled where the logits are (summed into every rank's
        copy) and the request starts."""
        tr, paged = self.transport, self.kv_layout == "paged"
        sync = self.transfer == "sync"
        ranks = self.roles is not None
        first = [0] * len(recs)
        if ranks:
            first = torch.zeros(len(recs), dtype=torch.int64, device=tr._wire_device())
            keeps_pool = self.role in ("attn", "attn+expert", "prefill")
        elif self.prefill_worker is not None:
            src, dst = self._hop_streams()
        waits = []
        for i, (req, slot, res, shared, fresh, h) in enumerate(recs):
            seed = self._next_seed()
            own = self.rows.start <= slot < self.rows.stop
            logits = None
            if res is None and (own or (paged and self.role != "expert")):
                t0 = time.perf_counter()
                if paged and h:
                    row = self.page_pool.gather_row(shared)
                    logits, row = suffix_prefill(self.params, self.cfg,
                                                 req.prompt, row, h)
                else:
                    toks = torch.tensor([req.prompt], dtype=torch.int64,
                                        device=self.device)
                    logits, row = prefill(self.params, self.cfg, toks,
                                          max_seq=self.max_seq, **self._extras())
                self.t_prefill += time.perf_counter() - t0
                t0 = time.perf_counter()
                if paged:
                    ps = self.page_pool.page_size
                    self.page_pool.write_row_span(fresh, row, len(shared) * ps,
                                                  len(req.prompt))
                else:
                    insert_rows(self.cache, row, slot - self.rows.start)
                self.t_transfer += time.perf_counter() - t0
                logits = logits if own else None
            elif res is not None and not ranks:
                t0 = time.perf_counter()
                if paged:
                    migrate_pages(self.page_pool, res.page_chunks, fresh, src=src,
                                  dst=dst, sync=sync, transport=tr)
                else:
                    migrate_kv(self.cache, res.kv, slot, src=src, dst=dst,
                               sync=sync, transport=tr)
                self.t_transfer += time.perf_counter() - t0
                logits = res.last_logits
            elif res is not None:
                t0 = time.perf_counter()
                if paged and keeps_pool:
                    for (_, chunk), page in zip(res.page_chunks, fresh):
                        hop = tr.broadcast(chunk, root=res.rank,
                                           group=tr.groups["kv"], kind="kv",
                                           like=self._page_like(), async_op=not sync)
                        waits.append((hop, lambda c, p=page:
                                      self.page_pool.write_chunk(p, c)))
                elif not paged and self.rank in (res.rank, self._owner(slot)):
                    hop = tr.broadcast(res.kv, root=res.rank,
                                       group=tr.pair(res.rank, self._owner(slot)),
                                       kind="kv", like=self._row_like(),
                                       async_op=not sync)
                    waits.append((hop, (lambda c, r=slot - self.rows.start:
                                        insert_rows(self.cache, c, r)) if own
                                  else (lambda c: None)))
                if sync:
                    for hop, write in waits:
                        write(hop.wait())
                    waits = []
                self.t_transfer += time.perf_counter() - t0
                logits = res.last_logits if self.rank == res.rank else None
            self.n_transfers += 1
            if logits is not None:
                first[i] = sample(logits, seed, self.sampling)[0]
        t0 = time.perf_counter()
        for hop, write in waits:
            write(hop.wait())
        self.t_transfer += time.perf_counter() - t0
        if ranks:
            first = tr.share(first)
        for (req, slot, *_), tok in zip(recs, first):
            tok = int(tok)
            req.slot = slot
            req.generated.append(tok)
            self._last_token[slot] = tok
            self.running[req.rid] = req
            self.n_prefills += 1

    def _row_like(self) -> List[dict]:
        """The shapes of one request's cache row (a KV hop's receive
        buffers)."""
        if not hasattr(self, "_row_tmpl"):
            self._row_tmpl = init_cache(self.cfg, 1, self.max_seq, dtype=self.dtype,
                                        device=self.device)
        return self._row_tmpl

    def _page_like(self) -> List[dict]:
        """The shapes of one page of every layer (a paged KV hop)."""
        if not hasattr(self, "_page_tmpl"):
            self._page_tmpl = [{k: t[0] for k, t in e.items()}
                               for e in self.page_pool.store]
        return self._page_tmpl

    def _held_bytes(self) -> int:
        """Bytes of parameters this rank keeps on its device (its
        runtime's placed expert slots included)."""
        ts = {id(t): t for t in _tensors(self.params)}
        if self.runtime is not None:
            for held in (self.runtime.layers_expert, self.runtime.layers_expert_placed):
                ts.update({id(t): t for t in _tensors(held or [])})
        return sum(t.numel() * t.element_size() for t in ts.values()
                   if t.device.type == self.device.type)

    def _merge_ranks(self, mine: dict) -> dict:
        """Every rank's ``_local_stats`` merged, the same on every rank:
        the first attention rank's counters, stages and expert report
        (the same on every rank, or merged over the decode ranks
        already); the prefill workers' counters summed over the prefill
        ranks; host phase times the slowest rank's; the transport ledger
        and kernel launches summed over the ranks.  ``ranks``: each rank's
        role, phases, ledger (with its waits), launches, parameter bytes
        on its device and peak device memory."""
        mine = dict(mine, rank=self.rank, role=self.role,
                    params_bytes=self._held_bytes(),
                    peak_bytes=(torch.cuda.max_memory_allocated(self.device)
                                if self.device.type == "cuda" else 0))
        every = self.transport.gather_objects(mine)
        out = dict(every[self.roles.attn[0]])
        ph = dict(out["phases"])
        for k in ("transfer_s", "decode_s"):
            ph[k] = max(r["phases"][k] for r in every)
        if self.prefill_worker is not None:
            pre = [every[r]["phases"] for r in self.roles.prefill]
            for k in ("prefill_s", "prefills", "prefill_batches", "prefill_tokens"):
                ph[k] = sum(p[k] for p in pre)
        out["phases"] = ph
        tr = {"backend": self.transport.name}
        for r in every:
            for kind, hop in r["transport"].items():
                if isinstance(hop, dict) and hop["hops"]:
                    acc = tr.setdefault(kind, {"hops": 0, "bytes": 0,
                                               "issue_s": 0.0, "sim_s": 0.0})
                    for k in acc:
                        acc[k] += hop[k]
        out["transport"] = tr
        out["kernel_launches"] = {k: sum(r["kernel_launches"][k] for r in every)
                                  for k in mine["kernel_launches"]}
        out["ranks"] = [{k: r[k] for k in ("rank", "role", "phases", "transport",
                                           "kernel_launches", "params_bytes",
                                           "peak_bytes")} for r in every]
        for k in ("rank", "role", "params_bytes", "peak_bytes"):
            out.pop(k)
        return out

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
        """``_local_stats``; across ranks every rank's merged, the same on
        each (every rank must call it: it gathers)."""
        out = self._local_stats()
        return self._merge_ranks(out) if self.roles is not None else out

    def _local_stats(self) -> EngineStats:
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
        decode_rank = self.role != "prefill"
        if self.mode == "pingpong":
            out["n_microbatches"] = len(self.mb_slices)
            if decode_rank:
                out["stages"] = self.runtime.stage_report()
        if self.cfg.moe is not None and self.runtime is not None and decode_rank:
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
