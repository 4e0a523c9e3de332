"""Model configuration for the PyTorch port.

The port keeps its own copy of the JAX package's config dataclasses
(``repro/config.py``) so that it imports nothing of that package; the
fields, their defaults and ``reduced`` are the same, so a config reads
and prints alike in both.  The port serves the ``attn``/``local`` layer
kinds; the other kinds stay in the dataclass so configs keep one shape.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

LAYER_KINDS = ("attn", "local", "cross", "selfcross", "rglru", "ssd")
# layer kinds the port can run today
SUPPORTED_KINDS = ("attn", "local")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    d_ff_dense_residual: int = 0
    capacity_factor: float = 1.25
    group_size: int = 2048
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 64
    conv_width: int = 4


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int
    conv_width: int = 4
    c: float = 8.0


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    source_len: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # default: d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    remainder_pattern: Tuple[str, ...] = ()
    window: int = 4096                  # sliding window for "local"
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    use_post_norm: bool = False
    act: str = "silu"                   # silu (swiglu) | gelu (geglu)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    cross_source_len: int = 0
    supports_long_context: bool = False
    long_context_note: str = ""
    source: str = ""

    def __post_init__(self):
        n_rem = len(self.remainder_pattern)
        n_pat = len(self.block_pattern)
        if (self.n_layers - n_rem) % n_pat != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} incompatible with "
                f"pattern of {n_pat} + remainder of {n_rem}")
        for k in self.block_pattern + self.remainder_pattern:
            if k not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")

    @property
    def n_blocks(self) -> int:
        return (self.n_layers - len(self.remainder_pattern)) // len(self.block_pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer in execution order: the block pattern
        repeated ``n_blocks`` times, then the remainder."""
        return self.block_pattern * self.n_blocks + self.remainder_pattern


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _load_all():
    from repro_torch import configs as _  # noqa: F401


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """A tiny same-family variant for CPU tests (same rule as the JAX
    package's ``reduced``, so both packages build the same shapes)."""
    hd = 64
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // ratio)
    pat = cfg.block_pattern
    layers = len(pat) * max(1, n_layers // len(pat)) if len(pat) <= n_layers else len(pat)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=128,
            d_ff_shared=128 if cfg.moe.n_shared_experts else 0,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            d_ff_dense_residual=128 if cfg.moe.d_ff_dense_residual else 0,
            group_size=64)
    ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=16) if cfg.ssm else None
    rgl = dataclasses.replace(cfg.rglru, lru_width=d_model) if cfg.rglru else None
    enc = dataclasses.replace(cfg.encoder, n_layers=2, source_len=32) if cfg.encoder else None
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd,
        d_ff=4 * d_model if cfg.d_ff else 0, vocab=vocab,
        block_pattern=pat, remainder_pattern=(), window=min(cfg.window, 16),
        moe=moe, ssm=ssm, rglru=rgl, encoder=enc,
        cross_source_len=16 if cfg.cross_source_len else 0)
