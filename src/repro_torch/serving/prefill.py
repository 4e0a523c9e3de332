"""Prefill cluster worker (paper §3: prefill/decode disaggregation), the
JAX package's ``serving/prefill.py`` on one card.

MegaScale-Infer decouples prefill from decoding so the decode side's
ping-pong pipeline, sized for memory-bound single-token work, never
stalls on a compute-bound prompt pass.  ``PrefillWorker`` is the prefill
side of that split:

  * the engine feeds it waiting requests (``submit``); the worker runs
    batched prefill (``pump``): consecutive same-length prompts share
    one ``models.transformer.prefill`` call, bounded by a
    ``chunk_tokens`` budget;
  * each completed request goes onto a FIFO transfer queue as a
    ``PrefillResult`` (the request's KV, its last-position logits, the
    greedy first token), in submission order;
  * the engine admits results into free KV rows and moves the KV over
    the transport (``kvcache.migrate_kv``, or ``migrate_pages`` per
    non-shared page in the paged layout).

On one card the worker runs on its own CUDA stream of the engine's
device, as the JAX launcher's single-device fallback shares its device
between the two clusters.  It shares the engine's parameter tensors (a
second copy would only take memory).  Each ``pump`` first orders the
worker's stream after the caller's, so a prefill reads the page pool
only after the decode work issued before it; the KV hop then orders the
decode stream after the worker's.

Prefill results depend only on the prompt, so the worker may run ahead
of slot availability without changing any token: admission order, not
prefill timing, decides the decode batch, and under greedy sampling the
tokens equal the inline-prefill engine's.

Across ranks (``ranks``: the prefill cluster's ranks) every rank of the
serving layout keeps the worker's queues, so that all of them batch the
same requests the same way, and batch k is computed by rank ``ranks[k %
P]`` alone: elsewhere the result carries no tensors, only its ``rank``,
the source of its KV hop.

Batching caveat: the modality stubs (``models.stubs.extra_inputs``) are
drawn per batch, so the models that need them (vision, audio) are
prefilled one request at a time, each with the stub the inline path's
B = 1 prefill gets.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.stubs import extra_inputs
from repro_torch.models.transformer import decode_step
from repro_torch.models.transformer import prefill as model_prefill
from repro_torch.serving.kvcache import extract_row
from repro_torch.serving.pages import n_pages_for, row_to_page_chunks


def suffix_prefill(params, cfg: ModelConfig, prompt: Sequence[int],
                   row_cache: List[dict], start: int):
    """Prefill only ``prompt[start:]`` on top of a one-request cache that
    already holds the first ``start`` tokens' KV (a radix prefix hit):
    the shared prefix is not recomputed.  The suffix runs as successive
    ``decode_step``s on the B = 1 row, which write their K/V into
    ``row_cache`` in place.  Returns ``(last_logits (1, V), row_cache)``.
    """
    if not start < len(prompt):
        raise ValueError(f"suffix start {start} leaves no token of a "
                         f"{len(prompt)}-token prompt")
    dev = params["embed"].device
    toks = torch.tensor(list(prompt[start:]), dtype=torch.int64, device=dev)
    pos = torch.arange(start, len(prompt), dtype=torch.int32, device=dev)
    logits = None
    for i in range(toks.shape[0]):
        logits, row_cache = decode_step(params, cfg, toks[i:i + 1], row_cache,
                                        pos[i:i + 1])
    return logits, row_cache


@dataclass
class PrefillResult:
    """A completed prefill: the transfer-queue entry the engine admits.

    ``kv`` is the request's cache (per layer, batch dim 1), made on the
    worker's stream; ``migrate_kv`` hands it to the decode cache.
    ``first_token`` is the greedy token as a 0-d tensor (not read back,
    so emitting a result never waits for the device); the engine samples
    from ``last_logits`` with its own seed stream at admission.

    Paged layout: ``kv`` is None and ``page_chunks`` holds the non-shared
    KV as per-page chunks (``pages.row_to_page_chunks``) for
    ``kvcache.migrate_pages``; ``shared_pages`` / ``n_shared_tokens``
    name the radix-hit prefix pages (pinned in the pool) that the engine
    links into the block table without a hop."""
    request: object                   # serving.engine.Request
    last_logits: torch.Tensor         # (1, V)
    first_token: torch.Tensor         # 0-d int64 (greedy argmax)
    kv: Optional[List[dict]]
    n_prompt_tokens: int
    t_prefill_s: float                # this request's share of its batch
    page_chunks: Optional[list] = None    # [(logical_page, chunk), ...]
    shared_pages: tuple = ()              # prefix-cache pages, pinned
    n_shared_tokens: int = 0
    rank: int = 0                         # the prefill rank that made it


class PrefillWorker:
    """Batched prefill on its own stream; a FIFO transfer queue of
    ``PrefillResult``."""

    def __init__(self, cfg: ModelConfig, params: dict, *, max_seq: int = 256,
                 chunk_tokens: int = 512,
                 prefill_fn: Optional[Callable] = None, page_size: int = 0,
                 page_pool=None, prefix_cache=None, device=None,
                 ranks: Sequence[int] = (), rank: int = 0):
        """``params``: the engine's parameter tensors (shared, not
        copied).  ``chunk_tokens``: token budget of one prefill batch;
        consecutive same-length prompts are batched while batch * length
        stays within it (a longer prompt runs alone).  ``prefill_fn``
        replaces ``models.transformer.prefill`` (tests); it takes
        ``(params, cfg, tokens, max_seq, capacity_mode=..., **extras)``.

        ``page_size`` > 0 makes the results paged: per-page chunks
        instead of whole rows.  With a ``prefix_cache`` (a
        ``serving.prefix_cache.PrefixCache`` over the decode engine's
        ``page_pool``) a radix hit gathers the cached prefix pages and
        runs ``suffix_prefill`` from the fork point, alone.  The engine
        links its own pool and prefix tree in when they are not given.

        ``device``: where the worker runs, by default the parameters'
        device; on the card the worker takes a stream of its own there.

        ``ranks`` / ``rank``: the prefill cluster's ranks and this one's
        (see the module's docstring); empty in one process."""
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.chunk_tokens = max(1, chunk_tokens)
        self.device = resolve_device(device if device is not None
                                     else params["embed"].device)
        self._batch_no = 0                  # every batch of the cluster
        self.ranks, self.rank = tuple(ranks), rank
        # on one card the worker overlaps decode on a stream of its own;
        # a prefill rank runs nothing else, so it prefills on the
        # caller's stream, where its KV hops read the results in order
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" and not self.ranks else None)
        self._prefill = prefill_fn or model_prefill
        self._needs_extras = bool(extra_inputs(cfg, 1, device=self.device))
        self.page_size = page_size
        self.page_pool = page_pool
        self.prefix_cache = prefix_cache
        self._hits: dict = {}               # rid -> (n_tokens, pages), pinned
        self.pending: deque = deque()       # submitted, not yet prefilled
        self.ready: deque = deque()         # the transfer queue (FIFO)
        self.n_prefills = 0
        self.n_batches = 0
        self.n_tokens = 0
        self.t_prefill_s = 0.0

    # ------------------------------------------------------------- frontend
    def submit(self, request) -> None:
        self.pending.append(request)

    @property
    def ready_count(self) -> int:
        return len(self.ready)

    @property
    def pending_count(self) -> int:
        return len(self.pending)

    def pop(self) -> Optional[PrefillResult]:
        """Next completed prefill in submission order, or None."""
        return self.ready.popleft() if self.ready else None

    # ------------------------------------------------------------- prefill
    def _lookup(self, req):
        """One prefix-cache lookup per request (memoised: a lookup pins
        the matched pages, so repeating it would pin them twice)."""
        if req.rid not in self._hits:
            self._hits[req.rid] = self.prefix_cache.lookup(req.prompt)
        return self._hits[req.rid]

    def _next_batch(self) -> list:
        """Pop the next batch: consecutive same-length prompts within the
        ``chunk_tokens`` budget (FIFO by construction).  A prefix-cache
        hit runs alone (the suffix path is B = 1); a hit further down the
        queue ends the batch."""
        batch = [self.pending.popleft()]
        if self.prefix_cache is not None and self._lookup(batch[0])[0]:
            return batch
        plen = len(batch[0].prompt)
        if self._needs_extras:
            return batch
        while (self.pending and len(self.pending[0].prompt) == plen
               and (len(batch) + 1) * plen <= self.chunk_tokens):
            if self.prefix_cache is not None \
                    and self._lookup(self.pending[0])[0]:
                break
            batch.append(self.pending.popleft())
        return batch

    def _paged_fields(self, req, row_cache, h: int, pages) -> dict:
        """PrefillResult fields of the paged transfer queue: the
        non-shared slots ``[h, plen)`` as per-page chunks (without
        tensors where ``row_cache`` is None: another rank's result)."""
        chunks = ([(lp, None) for lp in range(h // self.page_size,
                                              n_pages_for(len(req.prompt),
                                                          self.page_size))]
                  if row_cache is None else
                  row_to_page_chunks(row_cache, h, len(req.prompt), self.page_size))
        return {"kv": None, "page_chunks": chunks,
                "shared_pages": tuple(pages), "n_shared_tokens": h}

    def _source(self) -> int:
        """The rank that computes the next batch (this one in one
        process)."""
        src = self.ranks[self._batch_no % len(self.ranks)] if self.ranks else self.rank
        self._batch_no += 1
        return src

    def _elsewhere(self, batch: list, src: int, h: int = 0, pages=()) -> None:
        """Queue the results of a batch that rank ``src`` computes."""
        for req in batch:
            self._hits.pop(req.rid, None)
            extra = (self._paged_fields(req, None, h, pages) if self.page_size
                     else {"kv": None})
            self.ready.append(PrefillResult(
                request=req, last_logits=None, first_token=None,
                n_prompt_tokens=len(req.prompt), t_prefill_s=0.0, rank=src,
                **extra))

    def _run_suffix(self, req) -> None:
        """Radix-hit path: gather the cached prefix pages and compute
        only the suffix; the shared prefix is never run again."""
        h, pages = self._hits.pop(req.rid)
        src = self._source()
        if src != self.rank:
            self._elsewhere([req], src, h, pages)
            return
        t0 = time.perf_counter()
        row = self.page_pool.gather_row(pages)
        last_logits, row = suffix_prefill(self.params, self.cfg, req.prompt,
                                          row, h)
        dt = time.perf_counter() - t0
        self.t_prefill_s += dt
        self.n_batches += 1
        self.ready.append(PrefillResult(
            request=req, last_logits=last_logits,
            first_token=last_logits.argmax(-1)[0],
            n_prompt_tokens=len(req.prompt), t_prefill_s=dt, rank=src,
            **self._paged_fields(req, row, h, pages)))
        self.n_prefills += 1
        self.n_tokens += len(req.prompt) - h

    def _run_batch(self, batch: list) -> None:
        if (self.prefix_cache is not None and len(batch) == 1
                and self._hits.get(batch[0].rid, (0,))[0]):
            self._run_suffix(batch[0])
            return
        src = self._source()
        if src != self.rank:
            self._elsewhere(batch, src)
            return
        t0 = time.perf_counter()
        toks = torch.tensor([r.prompt for r in batch], dtype=torch.int64,
                            device=self.device)
        # the capacity the inline engine's B = 1 prefill resolves "auto"
        # to: batching must not move a request from drop-free "full" to
        # bounded "eval" capacity (prefill's threshold is B * T <= 2048),
        # or its tokens would differ from the inline path's
        capacity = "full" if toks.shape[1] <= 2048 else "eval"
        extras = (extra_inputs(self.cfg, len(batch),
                               dtype=self.params["embed"].dtype, device=self.device)
                  if self._needs_extras else {})
        last_logits, cache = self._prefill(self.params, self.cfg, toks,
                                           self.max_seq, capacity_mode=capacity,
                                           **extras)
        greedy = last_logits.argmax(-1)
        dt = time.perf_counter() - t0
        self.t_prefill_s += dt
        self.n_batches += 1
        for i, req in enumerate(batch):
            row = extract_row(cache, i)
            self._hits.pop(req.rid, None)   # a memoised (0, []) miss
            extra = (self._paged_fields(req, row, 0, ()) if self.page_size
                     else {"kv": row})
            self.ready.append(PrefillResult(
                request=req, last_logits=last_logits[i:i + 1],
                first_token=greedy[i], n_prompt_tokens=len(req.prompt),
                t_prefill_s=dt / len(batch), rank=src, **extra))
            self.n_prefills += 1
            self.n_tokens += len(req.prompt)

    def pump(self, max_batches: Optional[int] = None) -> int:
        """Run up to ``max_batches`` prefill batches (default: drain the
        pending queue) on the worker's stream.  Returns the number of
        batches run."""
        if self.stream is None:
            ctx = contextlib.nullcontext()
        else:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            ctx = torch.cuda.stream(self.stream)
        done = 0
        with ctx:
            while self.pending and (max_batches is None or done < max_batches):
                self._run_batch(self._next_batch())
                done += 1
        return done

    # -------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """This rank's prefills; one card's worker shares the decode
        side's device, a cluster of ranks counts its ranks."""
        return {"prefill_s": self.t_prefill_s, "prefills": self.n_prefills,
                "prefill_batches": self.n_batches,
                "prefill_tokens": self.n_tokens,
                "prefill_devices": max(1, len(self.ranks))}
