"""Versioned schema of ``Engine.stats()``, copied from the JAX package's
``serving/stats.py`` so the port's payload has the same keys and types.

``STATS_SCHEMA_VERSION`` is bumped on every breaking change (a key
removed, renamed or retyped); additive keys do not bump it.  The port
emits every key of the JAX payload and adds two of its own:
``device`` (the card's name, or "cpu") and ``kernel_launches`` (the
launch count of each CUDA kernel and branch).

Version history (the JAX package's):
  1  (implicit) — core counters + phases + stages + the §6 expert-balance
     report, no version field.
  2  — ``schema_version`` itself and the per-hop ``transport`` section.
  3  — ``use_kernels`` joins the core payload.
  4  — ``kv_layout`` joins the core payload, plus the optional
     ``kv_pages`` and ``prefix_cache`` sections for paged engines.
"""
from __future__ import annotations

from typing import Dict, List, TypedDict

STATS_SCHEMA_VERSION = 4


class PhaseStats(TypedDict, total=False):
    """Per-phase host-issue wall time (prefill / KV transfer / decode)."""
    prefill_s: float
    prefills: int
    prefill_batches: int
    prefill_tokens: int
    prefill_devices: int
    transfer_s: float
    transfer_n: int
    transfer_mode: str
    decode_s: float
    decode_n: int


class TransportHopStats(TypedDict):
    """One hop kind's cumulative counters (see ``core.transport``)."""
    hops: int
    bytes: int
    issue_s: float
    sim_s: float


class TransportStats(TypedDict, total=False):
    """Per-hop-kind transport accounting; ``backend`` names the backend
    ('inproc' | 'simrdma').  Kind keys appear only once that kind has
    traffic."""
    backend: str
    tokens: TransportHopStats
    kv: TransportHopStats
    weights: TransportHopStats
    collective: TransportHopStats


class PagePoolStats(TypedDict):
    """Page-pool accounting (``serving.pages.PagePool.stats``)."""
    n_pages: int
    page_size: int
    used: int
    free: int
    reserved: int
    high_water: int
    utilization: float
    allocs: int
    forks: int
    released: int


class PrefixCacheStats(TypedDict):
    """Radix prefix-cache counters (``serving.prefix_cache``)."""
    hits: int
    misses: int
    hit_rate: float
    hit_tokens: int
    evictions: int
    inserts: int
    nodes: int


class EngineStats(TypedDict, total=False):
    """The stable shape of ``Engine.stats()``.

    Keys marked optional appear only for the matching engine setup
    (ping-pong stages, MoE balance report, paged sections)."""
    schema_version: int
    finished: int
    tokens: int
    decode_iters: int
    prefills: int
    mean_latency_s: float
    mode: str
    use_kernels: bool
    disagg_prefill: bool
    kv_layout: str
    phases: PhaseStats
    # paged KV layout only
    kv_pages: PagePoolStats
    prefix_cache: PrefixCacheStats
    # ping-pong runtime only
    n_microbatches: int
    stages: dict
    transport: TransportStats
    # live expert balance report (MoE with a disaggregated runtime)
    imbalance: float
    expert_node_cost: List[float]
    expert_loads: List[float]
    rebalances: int
    placement_updates: int
    rebalance_s: float
    replicated_experts: int
    # the port's additive keys
    device: str
    kernel_launches: Dict[str, int]
