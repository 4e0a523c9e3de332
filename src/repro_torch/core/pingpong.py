"""Ping-pong pipeline parallelism (paper §4.1), copied from the JAX
package's ``core/pingpong.py`` so the port imports nothing of it.

The paper's feasibility conditions (eq. 1-3), the latency model (eq.
4-5), a discrete-event simulator of the attention/expert shuttle, and
the schedule the disaggregated runtime (``core.disagg``) issues work in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple


def min_microbatches(t_c: float, t_f: float) -> int:
    """Paper: m >= 2 * (1 + T_c / T_f).  3 for fast nets, 4 for slow."""
    return max(1, math.ceil(2.0 * (1.0 + t_c / t_f)))


def choose_microbatches(t_a: float, t_e: float, t_c: float, *,
                        max_m: int | None = None) -> int:
    """The runtime's micro-batch count from measured stage times: the
    feasibility bound ``min_microbatches`` on the T_a / T_e / T_c of one
    profiled decode iteration, clamped to ``max_m`` (the engine cannot
    split its batch into more micro-batches than it has KV rows)."""
    t_f = max(t_a, t_e, 1e-12)
    m = min_microbatches(t_c, t_f)
    if max_m is not None:
        m = min(m, max(1, max_m))
    return max(1, m)


def conditions_met(t_a: float, t_e: float, t_c: float, m: int,
                   balance_tol: float = 0.25) -> dict:
    """Check constraints (1)-(3); returns per-constraint booleans."""
    t_f = max(t_a, t_e)
    return {
        "balanced": abs(t_a - t_e) <= balance_tol * t_f,          # eq. (1)
        "comm_hidden": t_c < t_f,                                  # eq. (2)
        "pipeline_full": m * t_f >= 2.0 * (t_f + t_c),             # eq. (3)
    }


def iteration_latency(t_a: float, t_e: float, t_c: float, m: int,
                      n_layers: int) -> float:
    """Paper eq. (5): T_total = (T_a + T_e + 2 T_c) + T_f (m L - 1)."""
    t_f = max(t_a, t_e)
    return (t_a + t_e + 2.0 * t_c) + t_f * (m * n_layers - 1)


def microbatch_latency_bounds(t_a: float, t_e: float, t_c: float, m: int,
                              n_layers: int) -> Tuple[float, float]:
    """Paper eq. (4) bounds on a single micro-batch's iteration latency."""
    t_f = max(t_a, t_e)
    lo = (t_a + t_e + 2 * t_c) + m * t_f * (n_layers - 1)
    hi = m * t_f * n_layers
    return lo, hi


@dataclass
class SimResult:
    total_time: float
    attn_busy: float
    expert_busy: float
    attn_util: float
    expert_util: float
    events: List[Tuple[float, float, str, int, int]]  # (start,end,phase,mb,layer)


def simulate_pingpong(t_a: float, t_e: float, t_c: float, m: int,
                      n_layers: int, record_events: bool = False) -> SimResult:
    """Discrete-event simulation of the ping-pong pipeline.

    Two exclusive resources (attention group, expert group); each
    micro-batch does, per layer: attn compute -> M2N send -> expert
    compute -> N2M send -> (next layer).  Communication occupies neither
    compute resource (the paper's overlap assumption).
    """
    attn_free = 0.0
    expert_free = 0.0
    # ready time for each micro-batch's next attention phase
    ready = [0.0] * m
    events = []
    finish = 0.0
    attn_busy = 0.0
    expert_busy = 0.0
    # layer by layer; within a layer, micro-batches in index order (the
    # paper's fig. 4 schedule)
    for layer in range(n_layers):
        for mb in range(m):
            start = max(attn_free, ready[mb])
            end = start + t_a
            attn_free = end
            attn_busy += t_a
            if record_events:
                events.append((start, end, "attn", mb, layer))
            arrive = end + t_c
            e_start = max(expert_free, arrive)
            e_end = e_start + t_e
            expert_free = e_end
            expert_busy += t_e
            if record_events:
                events.append((e_start, e_end, "expert", mb, layer))
            ready[mb] = e_end + t_c
            finish = max(finish, ready[mb])
    # the last N2M included: tokens back at attention.  Kept as the JAX
    # package writes it, so the two agree to the last bit
    total = finish - t_c + t_c
    return SimResult(
        total_time=total,
        attn_busy=attn_busy, expert_busy=expert_busy,
        attn_util=attn_busy / total, expert_util=expert_busy / total,
        events=events)


def throughput(global_batch: int, t_total: float) -> float:
    """Decoding throughput (tokens/s) of one instance: B tokens per step."""
    return global_batch / t_total


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


def schedule_from_events(events) -> List[Tuple[str, int, int]]:
    """Project simulator events (``simulate_pingpong(...,
    record_events=True).events``) onto the runtime op order, comparable
    with ``build_schedule`` and ``DisaggregatedInstance.last_trace``."""
    return [(phase, mb, layer) for (_, _, phase, mb, layer) in events]
