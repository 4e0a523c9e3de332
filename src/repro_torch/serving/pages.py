"""Paged KV cache: a fixed-size pool of refcounted pages shared by every
layer, and per-request block tables (the JAX package's
``serving/pages.py``).

A page holds ``page_size`` token slots.  One physical page id selects
the same page in every layer's store, so one block table per request
(logical page -> physical page, -1 = unmapped) describes its whole
cache.  The store mirrors the port's contiguous cache
(``models.transformer.init_cache``) with the ``(B, W)`` row grid
replaced by the ``(P, ps)`` page grid:

  contiguous, per layer                 paged, per layer
  k/v  (B, W, Hkv, hd)             ->   (P, ps, Hkv, hd)
  pos  (B, W) int32                ->   (P, ps) int32

``gather`` of a block table gives the dense ``(B, W)`` cache exactly
(unmapped and unwritten slots read ``pos = -1``, as a reset row does),
which is how the engine keeps paged decode token-identical to the
contiguous layout.

Host state (free list, refcounts, reservations) is plain Python and
numpy: allocation decisions never wait for the device.
"""
from __future__ import annotations

from collections import deque
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import cache_len


class PageError(RuntimeError):
    """Page-pool invariant violation or out-of-pages condition."""


def paged_supported(cfg: ModelConfig, max_seq: int,
                    page_size: int) -> Tuple[bool, str]:
    """Whether ``cfg``'s cache can use the paged layout, and why not:
    every layer's ring must span the full ``max_seq`` (a "local" layer
    with a smaller window wraps at another period than the shared block
    table), and ``max_seq`` must be a whole number of pages."""
    if page_size <= 0:
        return False, f"page_size must be positive, got {page_size}"
    if max_seq % page_size:
        return False, (f"max_seq={max_seq} is not a whole number of "
                       f"pages of {page_size}")
    for kind in cfg.layer_kinds:
        if kind not in ("attn", "local"):
            return False, (f"layer kind {kind!r} carries non-KV cache "
                           f"state (paged layout pages only k/v/pos)")
        if cache_len(cfg, kind, max_seq) != max_seq:
            return False, (f"'local' window {cfg.window} < max_seq "
                           f"{max_seq}: ring period differs from the "
                           f"block table's")
    return True, ""


def n_pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` consecutive slots."""
    return -(-max(0, n_tokens) // page_size)


def _device_index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index array on ``device``.  On the card the copy goes
    through pinned memory, so it is queued behind the work already on
    the stream: a copy from pageable memory makes the host wait for that
    work first (the write-back follows a whole decode step)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def row_to_page_chunks(row_cache: List[dict], start_slot: int, end_slot: int,
                       page_size: int) -> List[Tuple[int, List[dict]]]:
    """Split a dense one-request cache (per layer ``(1, W, ...)``) into
    per-page chunks ``[(logical_page, chunk), ...]`` covering slots
    ``[start_slot, end_slot)``; ``start_slot`` must be page-aligned.  A
    chunk is one pool page of every layer: per layer ``{k, v: (ps, Hkv,
    hd), pos: (ps,)}``, views of the row."""
    if start_slot % page_size:
        raise PageError(f"chunk start {start_slot} not page-aligned "
                        f"(page_size={page_size})")
    chunks = []
    for lp in range(start_slot // page_size, n_pages_for(end_slot, page_size)):
        s0 = lp * page_size
        chunks.append((lp, [{k: t[0, s0:s0 + page_size]
                             for k, t in entry.items()}
                            for entry in row_cache]))
    return chunks


class PagePool:
    """Fixed-size pool of refcounted KV pages shared by every layer.

    Invariants (checked, not assumed):
      * a page is either on the free list or has refcount >= 1;
      * ``free + in_use == n_pages`` at all times;
      * reservations never exceed the free count, so an admitted
        request can always grow to its reserved worst case (OOM-safe
        admission by accounting).
    """

    def __init__(self, cfg: ModelConfig, *, n_pages: int, page_size: int,
                 max_seq: int, dtype=torch.float32, device="cuda",
                 with_store: bool = True):
        """``with_store`` False keeps the host state only (free list,
        refcounts, reservations): the pool of a rank that runs the
        engine's schedule but holds no KV (an expert rank); its device
        writes and copies do nothing."""
        ok, why = paged_supported(cfg, max_seq, page_size)
        if not ok:
            raise PageError(f"paged KV layout unsupported for "
                            f"{cfg.name}: {why}")
        if n_pages <= 0:
            raise PageError(f"n_pages must be positive, got {n_pages}")
        self.cfg = cfg
        self.page_size = page_size
        self.max_seq = max_seq
        self.n_pages = n_pages
        self.n_logical = max_seq // page_size
        self.device = resolve_device(device)
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        shape = (n_pages, page_size, Hkv, hd)
        self.store: List[dict] = [
            {"k": torch.zeros(shape, dtype=dtype, device=self.device),
             "v": torch.zeros(shape, dtype=dtype, device=self.device),
             "pos": torch.full((n_pages, page_size), -1, dtype=torch.int32,
                               device=self.device)}
            for _ in cfg.layer_kinds] if with_store else []
        self.free: deque = deque(range(n_pages))
        self.refcount = np.zeros((n_pages,), np.int32)
        self.reserved = 0
        self.high_water = 0
        self.n_allocs = 0
        self.n_forks = 0
        self.n_released = 0

    # ------------------------------------------------------------- accounting
    @property
    def used(self) -> int:
        return self.n_pages - len(self.free)

    @property
    def available(self) -> int:
        """Pages allocatable without eating into reservations."""
        return len(self.free) - self.reserved

    def reserve(self, n: int) -> bool:
        """Set aside ``n`` pages for a future holder; False if fewer are
        available."""
        if n < 0:
            raise PageError(f"reserve({n})")
        if n > self.available:
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int):
        if n < 0 or n > self.reserved:
            raise PageError(f"unreserve({n}) with {self.reserved} reserved")
        self.reserved -= n

    # ------------------------------------------------------------ page lifecycle
    def alloc(self, *, from_reserve: bool = False, _reset: bool = True) -> int:
        """Allocate one page (refcount 1).  ``from_reserve`` spends a page
        set aside with ``reserve``.  The page's ``pos`` slots are reset to
        -1 in every layer, so a recycled page never exposes its previous
        holder's tokens (stale k/v bytes stay unreachable behind them)."""
        if from_reserve:
            if self.reserved <= 0:
                raise PageError("alloc(from_reserve=True) with no "
                                "reservation outstanding")
            self.reserved -= 1
        elif self.available <= 0:
            raise PageError(f"out of pages ({self.n_pages} total, "
                            f"{self.reserved} reserved)")
        if not self.free:
            raise PageError("free list empty (reservation accounting bug)")
        page = self.free.popleft()
        if self.refcount[page]:
            raise PageError(f"page {page} on free list with refcount "
                            f"{self.refcount[page]}")
        self.refcount[page] = 1
        self.n_allocs += 1
        self.high_water = max(self.high_water, self.used)
        if _reset:
            for entry in self.store:
                entry["pos"][page] = -1
        return page

    def retain(self, page: int):
        if self.refcount[page] <= 0:
            raise PageError(f"retain of free page {page}")
        self.refcount[page] += 1

    def release(self, page: int):
        if self.refcount[page] <= 0:
            raise PageError(f"release of free page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self.free.append(page)
            self.n_released += 1

    def is_shared(self, page: int) -> bool:
        return bool(self.refcount[page] > 1)

    def fork(self, page: int, *, from_reserve: bool = False) -> int:
        """Copy-on-write: allocate a fresh page, copy ``page`` into it in
        every layer's K, V and pos, and drop one reference to the
        original.  The caller swaps the returned id into its block table;
        every other holder keeps the original."""
        if self.refcount[page] <= 0:
            raise PageError(f"fork of free page {page}")
        new = self.alloc(from_reserve=from_reserve, _reset=False)
        for entry in self.store:
            for t in entry.values():
                t[new].copy_(t[page])
        self.release(page)
        self.n_forks += 1
        return new

    # ----------------------------------------------------------------- device IO
    def write_row_span(self, pages: Sequence[int], row_cache: List[dict],
                       start_slot: int, end_slot: int):
        """Write slots ``[start_slot, end_slot)`` of a dense one-request
        cache (per-layer ``(1, W, ...)``) into ``pages``, one physical
        page per covered logical page, in order.  ``start_slot`` must be
        page-aligned; the last page is written in full (its trailing
        slots carry the row's ``pos = -1``)."""
        ps = self.page_size
        if start_slot % ps:
            raise PageError(f"span start {start_slot} not page-aligned "
                            f"(page_size={ps})")
        first = start_slot // ps
        n = n_pages_for(end_slot, ps) - first
        if n != len(pages):
            raise PageError(f"{len(pages)} pages for {n} chunks")
        for p in pages:
            if self.refcount[p] <= 0:
                raise PageError(f"write to free page {p}")
        if not n:
            return
        idx = _device_index(np.asarray(pages), self.device)
        s0, s1 = first * ps, (first + n) * ps
        for full, part in zip(self.store, row_cache):
            for key, t in full.items():
                src = part[key][0, s0:s1]
                t[idx] = src.reshape((n, ps) + tuple(src.shape[1:])).to(t.dtype)

    def write_chunk(self, page: int, chunk: List[dict]):
        """Install one page-shaped chunk (``row_to_page_chunks``, moved
        by ``kvcache.migrate_pages``) into physical ``page``."""
        if self.refcount[page] <= 0:
            raise PageError(f"write to free page {page}")
        for full, part in zip(self.store, chunk):
            for key, t in full.items():
                t[page].copy_(part[key])

    def write_tokens(self, dense_cache: List[dict], rows: np.ndarray,
                     slots: np.ndarray, pages: np.ndarray,
                     offsets: np.ndarray):
        """Scatter freshly decoded per-token KV back into the pool: for
        each i, dense row ``rows[i]`` slot ``slots[i]`` lands in physical
        page ``pages[i]`` offset ``offsets[i]``.  One scatter per leaf,
        so the per-step write-back is O(B), not O(B * W)."""
        if len(rows) == 0:
            return
        idx = _device_index(np.stack([rows, slots, pages, offsets]),
                            self.device)
        rows_t, slots_t, pages_t, offs_t = idx
        for full, dense in zip(self.store, dense_cache):
            for key, t in full.items():
                t[pages_t, offs_t] = dense[key][rows_t, slots_t].to(t.dtype)

    def gather(self, block_tables: np.ndarray) -> List[dict]:
        """The dense per-layer ``(B, W)`` cache for a batch of block
        tables (``(B, n_logical)`` int32, -1 = unmapped).  Unmapped
        logical pages read as empty (``pos = -1``), so the result is what
        the contiguous layout's cache would hold.  The result is a fresh
        tensor per leaf; nothing else holds it."""
        bt = np.asarray(block_tables)
        if bt.ndim != 2 or bt.shape[1] != self.n_logical:
            raise PageError(f"block table shape {bt.shape} != "
                            f"(B, {self.n_logical})")
        B, W = bt.shape[0], self.max_seq
        bt_t = _device_index(bt, self.device)
        btc = bt_t.clamp(min=0)
        mapped = (bt_t >= 0)[:, :, None]
        out = []
        for entry in self.store:
            k, v, pos = entry["k"], entry["v"], entry["pos"]
            out.append({
                "k": k[btc].reshape((B, W) + tuple(k.shape[2:])),
                "v": v[btc].reshape((B, W) + tuple(v.shape[2:])),
                "pos": torch.where(mapped, pos[btc], -1).reshape(B, W)})
        return out

    def gather_row(self, pages: Sequence[int]) -> List[dict]:
        """Dense one-request cache (batch dim 1) for a page chain, the
        inverse of ``write_row_span`` (logical pages past the chain read
        as empty)."""
        bt = np.full((1, self.n_logical), -1, np.int32)
        bt[0, :len(pages)] = pages
        return self.gather(bt)

    # -------------------------------------------------------------- metrics
    def stats(self) -> dict:
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "used": self.used,
            "free": len(self.free),
            "reserved": self.reserved,
            "high_water": self.high_water,
            "utilization": self.used / self.n_pages,
            "allocs": self.n_allocs,
            "forks": self.n_forks,
            "released": self.n_released,
        }
