"""Typed serving configuration of the port: the fields of the JAX
package's ``ServingConfig`` that the port supports, under the same
names and defaults, plus what running at full width on one card needs
(the layer count cut, the weight dtype, the device) and the count of
expert nodes the placement and the m2n dispatch are solved for (the
JAX package takes it from its expert devices)."""
from __future__ import annotations

import argparse
from dataclasses import dataclass, fields, replace
from typing import Union

from repro_torch.core.transport import TRANSPORTS
from repro_torch.serving.sampler import SamplingParams

RUNTIMES = ("monolithic", "disagg", "pingpong")
TRANSFERS = ("sync", "async")
DTYPES = ("float32", "bfloat16")
KV_LAYOUTS = ("contiguous", "paged")


@dataclass
class ServingConfig:
    # ---- workload / launcher ------------------------------------------
    arch: str = "mixtral-8x22b"
    use_reduced: bool = True
    n_layers: int = 0                  # 0 = the config's depth
    dtype: str = "float32"             # weights and KV cache
    device: str = "cuda"
    runtime: str = "monolithic"        # monolithic | disagg | pingpong
    n_requests: int = 8
    max_new: int = 8
    prompt_len: int = 0                # 0 = random lengths
    warmup_requests: int = 0
    zipf_route_bias: float = 0.0
    verbose: bool = True
    # ---- decode runtime ------------------------------------------------
    microbatches: Union[int, str] = 3  # int, or "auto" (paper eq. 3)
    use_m2n: bool = False
    profile_stages: bool = False
    # ---- transport / clusters (paper §3-§4) ----------------------------
    transport: str = "inproc"          # inproc | simrdma | multi
    expert_nodes: int = 1              # expert nodes placement and m2n see
    prefill_devices: int = 0           # 0 = inline prefill
    transfer: str = "async"            # KV migration: sync | async
    prefill_chunk_tokens: int = 512
    # ---- KV cache layout (paged subsystem) ------------------------------
    kv_layout: str = "contiguous"      # contiguous | paged
    page_size: int = 16                # token slots per KV page (paged)
    kv_pool_pages: int = 0             # 0 = auto-size from max_batch/max_seq
    prefix_cache: bool = True          # radix prefix reuse (paged only)
    shared_prefix_len: int = 0         # workload: shared system-prompt tokens
    # ---- engine ---------------------------------------------------------
    max_batch: int = 4
    max_seq: int = 128
    seed: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    expert_rebalance_every: int = 0
    expert_replication: bool = True
    expert_window: int = 8

    def __post_init__(self):
        if self.runtime not in RUNTIMES:
            raise ValueError(f"runtime must be one of {RUNTIMES}, "
                             f"got {self.runtime!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {self.dtype!r}")
        if self.transfer not in TRANSFERS:
            raise ValueError(f"transfer must be one of {TRANSFERS}, "
                             f"got {self.transfer!r}")
        if self.prefill_devices < 0:
            raise ValueError(f"prefill_devices must be >= 0, "
                             f"got {self.prefill_devices}")
        if self.transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {sorted(TRANSPORTS)}, "
                             f"got {self.transport!r}")
        if self.expert_nodes < 1:
            raise ValueError(f"expert_nodes must be >= 1, "
                             f"got {self.expert_nodes}")
        if self.expert_rebalance_every < 0:
            raise ValueError(f"expert_rebalance_every must be >= 0, "
                             f"got {self.expert_rebalance_every}")
        if self.microbatches != "auto":
            self.microbatches = int(self.microbatches)
            if self.microbatches < 1:
                raise ValueError("microbatches must be >= 1 or 'auto'")
        if self.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, "
                             f"got {self.kv_layout!r}")
        if self.kv_layout == "paged":
            if self.page_size <= 0:
                raise ValueError(f"page_size must be positive, "
                                 f"got {self.page_size}")
            if self.max_seq % self.page_size:
                raise ValueError(f"max_seq={self.max_seq} must be a whole "
                                 f"number of pages of {self.page_size}")

    @property
    def n_pool_pages(self) -> int:
        """Page-pool size: explicit, or auto: enough for every batch row
        plus two spare rows' worth of pages, so the prefix cache can keep
        recently finished chains without starving admission."""
        if self.kv_pool_pages:
            return self.kv_pool_pages
        return (self.max_batch + 2) * (self.max_seq // self.page_size)

    @property
    def engine_mode(self) -> str:
        """The engine mode of the runtime: ``disagg`` is a monolithic
        engine whose decode step is the disaggregated runtime's."""
        return "pingpong" if self.runtime == "pingpong" else "monolithic"

    def sampling_params(self) -> SamplingParams:
        return SamplingParams(temperature=self.temperature,
                              top_k=self.top_k, top_p=self.top_p)

    _ARG_ALIASES = {"requests": "n_requests", "reduced": "use_reduced"}

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ServingConfig":
        known = {f.name for f in fields(cls)}
        kw = {}
        for dest, val in vars(args).items():
            name = cls._ARG_ALIASES.get(dest, dest)
            if name in known and val is not None:
                kw[name] = val
        return cls(**kw)

    def with_overrides(self, **kw) -> "ServingConfig":
        return replace(self, **kw)
