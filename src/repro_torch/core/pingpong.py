"""Ping-pong schedule helpers (paper §4.1), copied from the JAX package's
``core/pingpong.py`` so the port imports nothing of it."""
from __future__ import annotations

from typing import List, Tuple


def even_partition(n: int, m: int) -> List[slice]:
    """Split ``n`` rows into <= m contiguous near-even slices (sizes
    differ by at most one).  Used for both the runtime's default
    micro-batch split and the engine's KV slot groups, so the two can
    never desynchronise."""
    m = max(1, min(m, n))
    base, extra = divmod(n, m)
    out, start = [], 0
    for i in range(m):
        size = base + (1 if i < extra else 0)
        out.append(slice(start, start + size))
        start += size
    return out


def build_schedule(m: int, n_layers: int) -> List[Tuple[str, int, int]]:
    """Op order of the disaggregated runtime: [(phase, mb, layer), ...].
    While expert(mb) runs, attn(mb+1) is issued."""
    ops = []
    for layer in range(n_layers):
        for mb in range(m):
            ops.append(("attn", mb, layer))
            ops.append(("expert", mb, layer))
    return ops
