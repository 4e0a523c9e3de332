"""Batch-slot KV-cache management for continuous batching (contiguous
layout): a request owns one row of every layer's (B_max, W) ring buffer
for its lifetime.  Rows are written in place.  With the prefill cluster
(``serving.prefill.PrefillWorker``) a request's KV reaches the decode
cache through a transport hop: a whole row (``migrate_kv``) or, in the
paged layout, one hop per non-shared page (``migrate_pages``)."""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.pingpong import even_partition
from repro_torch.core.transport import InProcessTransport


def insert_rows(cache: List[dict], request_cache: List[dict], row: int):
    """Copy a single-request cache (batch dim 1) into row ``row``."""
    for full, part in zip(cache, request_cache):
        for key, t in full.items():
            t[row].copy_(part[key][0])
    return cache


def extract_row(cache: List[dict], row: int) -> List[dict]:
    """One request's cache (batch dim 1) out of a batched cache, the
    inverse of ``insert_rows``: views of row ``row``."""
    return [{k: t[row:row + 1] for k, t in entry.items()} for entry in cache]


def migrate_kv(cache: List[dict], request_cache: List[dict], row: int, *,
               src=None, dst=None, sync: bool = False, transport=None):
    """The prefill->decode KV hop: hand one request's cache (batch dim 1,
    made on stream ``src``) to stream ``dst`` through ``transport`` (one
    "kv" hop), then write it into row ``row`` of ``cache`` on the
    caller's stream.  ``sync`` makes the host wait until the request's
    cache is made; otherwise only ``dst`` waits.  On the CPU both streams
    are None.  Without a ``transport`` the hop goes through a private
    ``InProcessTransport``."""
    if transport is None:
        transport = InProcessTransport()
    transport.migrate_kv(request_cache, dst, src=src, sync=sync)
    return insert_rows(cache, request_cache, row)


def migrate_pages(pool, chunks: Sequence[Tuple[int, List[dict]]],
                  pages: Sequence[int], *, src=None, dst=None,
                  sync: bool = False, transport=None):
    """Page-granular prefill->decode KV hop: each per-page chunk (from
    ``pages.row_to_page_chunks``) is one "kv" hop, then written into its
    physical page of ``pool``.  With a prefix-cache hit only the
    request's non-shared pages are in ``chunks``."""
    if transport is None:
        transport = InProcessTransport()
    if len(chunks) != len(pages):
        raise ValueError(f"{len(pages)} pages for {len(chunks)} chunks")
    for (_, chunk), page in zip(chunks, pages):
        transport.migrate_pages(chunk, dst, src=src, sync=sync)
        pool.write_chunk(page, chunk)
    return pool


def reset_row(cache: List[dict], row: int):
    """Invalidate a row (request finished): mark its KV positions empty
    and zero its recurrent states (``h``, ``ssm``), so a recycled slot
    never exposes the previous request's cache.  As in the JAX package,
    the conv caches and the cross K/V stay: the next request's prefill
    overwrites them whole."""
    for entry in cache:
        if "pos" in entry:
            entry["pos"][row] = -1
        for key in ("h", "ssm"):
            if key in entry:
                entry[key][row] = 0
    return cache


class SlotAllocator:
    """FIFO batch-row allocator; a slot is held by at most one request."""

    def __init__(self, n_slots: int):
        self.free: Deque[int] = deque(range(n_slots))
        self.used: Dict[int, int] = {}  # request id -> slot
        self._held = set()

    def alloc(self, rid: int) -> Optional[int]:
        if rid in self.used:
            raise ValueError(f"request {rid} already holds slot "
                             f"{self.used[rid]}")
        if not self.free:
            return None
        slot = self.free.popleft()
        if slot in self._held:
            raise RuntimeError(f"KV slot {slot} double-assigned "
                               f"(rid={rid}, holder={self.used})")
        self._held.add(slot)
        self.used[rid] = slot
        return slot

    def release(self, rid: int) -> int:
        slot = self.used.pop(rid)
        self._held.discard(slot)
        self.free.append(slot)
        return slot


def mb_slot_ranges(n_slots: int, m: int) -> List[slice]:
    """Partition ``n_slots`` KV rows into <= m contiguous micro-batch
    groups of near-even size (``pingpong.even_partition``): each group's
    cache is a plain view."""
    return even_partition(n_slots, m)


class MicrobatchSlotAllocator:
    """Slot allocator aware of micro-batch groups (ping-pong serving).

    Each slot belongs to one contiguous group (``pingpong.even_partition``
    of the rows, so each micro-batch's cache is a plain view).  A request
    goes to the group with the most free slots unless a group is named.
    A slot is held by at most one request and only ever returns to its
    own group.
    """

    def __init__(self, n_slots: int, groups: List[slice]):
        if groups[0].start != 0 or groups[-1].stop != n_slots or any(
                a.stop != b.start for a, b in zip(groups, groups[1:])):
            raise ValueError(f"groups {groups} must tile [0, {n_slots})")
        self.groups = list(groups)
        self.free_by_group: List[Deque[int]] = [
            deque(range(s.start, s.stop)) for s in groups]
        self.used: Dict[int, int] = {}
        self._held = set()
        self._slot_group: List[int] = [0] * n_slots
        for gi, s in enumerate(groups):
            for slot in range(s.start, s.stop):
                self._slot_group[slot] = gi

    @property
    def free(self) -> List[int]:
        return [s for g in self.free_by_group for s in g]

    def group_of(self, slot: int) -> int:
        if not 0 <= slot < len(self._slot_group):
            raise ValueError(f"slot {slot} outside all groups")
        return self._slot_group[slot]

    def alloc(self, rid: int, group: Optional[int] = None) -> Optional[int]:
        if rid in self.used:
            raise ValueError(f"request {rid} already holds slot "
                             f"{self.used[rid]}")
        if group is None:
            candidates = [gi for gi, f in enumerate(self.free_by_group) if f]
            if not candidates:
                return None
            group = max(candidates, key=lambda gi: len(self.free_by_group[gi]))
        if not self.free_by_group[group]:
            return None
        slot = self.free_by_group[group].popleft()
        if slot in self._held:
            raise RuntimeError(f"KV slot {slot} double-assigned "
                               f"(rid={rid}, holder={self.used})")
        self._held.add(slot)
        self.used[rid] = slot
        return slot

    def release(self, rid: int) -> int:
        slot = self.used.pop(rid)
        self._held.discard(slot)
        self.free_by_group[self.group_of(slot)].append(slot)
        return slot
