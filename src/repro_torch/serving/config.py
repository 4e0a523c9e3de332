"""Typed serving configuration of the port: the fields of the JAX
package's ``ServingConfig`` that this slice supports, under the same
names, plus what running at full width on one card needs (the layer
count cut, the weight dtype, the device)."""
from __future__ import annotations

import argparse
from dataclasses import dataclass, fields, replace

from repro_torch.serving.sampler import SamplingParams

RUNTIMES = ("monolithic", "pingpong")
DTYPES = ("float32", "bfloat16")


@dataclass
class ServingConfig:
    # ---- workload / launcher ------------------------------------------
    arch: str = "mixtral-8x22b"
    use_reduced: bool = True
    n_layers: int = 0                  # 0 = the config's depth
    dtype: str = "float32"             # weights and KV cache
    device: str = "cuda"
    runtime: str = "monolithic"        # monolithic | pingpong
    n_requests: int = 8
    max_new: int = 8
    prompt_len: int = 0                # 0 = random lengths
    warmup_requests: int = 0
    verbose: bool = True
    # ---- decode runtime ------------------------------------------------
    microbatches: int = 3
    # ---- engine ---------------------------------------------------------
    max_batch: int = 4
    max_seq: int = 128
    seed: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.runtime not in RUNTIMES:
            raise ValueError(f"runtime must be one of {RUNTIMES}, "
                             f"got {self.runtime!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {self.dtype!r}")
        self.microbatches = int(self.microbatches)
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")

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
