"""Model configuration for the PyTorch port.

The port keeps its own copy of the JAX package's config dataclasses
(``repro/config.py``) so that it imports nothing of that package; the
fields, their defaults, the analytic parameter counts and ``reduced``
are the same, so a config reads, prints and counts alike in both.

Layer kinds (one token-mixing module + one FFN per layer, except noted):
  "attn"      global causal self-attention + FFN
  "local"     sliding-window causal self-attention + FFN
  "cross"     (gated) cross-attention to static source embeddings + FFN
  "selfcross" self-attention + cross-attention + FFN  (whisper decoder)
  "rglru"     RG-LRU recurrent block + FFN            (recurrentgemma)
  "ssd"       Mamba-2 SSD block (no separate FFN)

A model's layer stack is ``block_pattern`` repeated ``n_blocks`` times
followed by ``remainder_pattern`` (``ModelConfig.layer_kinds``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

LAYER_KINDS = ("attn", "local", "cross", "selfcross", "rglru", "ssd")


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
    """Mamba-2 SSD configuration."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 64
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU (Griffin / RecurrentGemma) recurrent block configuration."""
    lru_width: int
    conv_width: int = 4
    c: float = 8.0             # c exponent in a_t = a^(c * r_t)


@dataclass(frozen=True)
class EncoderConfig:
    """Auxiliary encoder (whisper audio encoder) over precomputed frame
    embeddings from the stubbed conv/mel frontend."""
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

    @property
    def has_cross(self) -> bool:
        return any(k in ("cross", "selfcross") for k in self.layer_kinds)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + all layers + encoder),
        the JAX package's count term for term."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab * d
        if not self.tie_embeddings:
            total += self.vocab * d
        total += d                                       # final norm
        total += sum(_layer_params(self, k) for k in self.layer_kinds)
        if self.encoder is not None:
            qkv = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                   + self.n_heads * hd * d)
            enc_layer = qkv + 3 * d * self.d_ff + 2 * d
            total += self.encoder.n_layers * enc_layer + d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return self.param_count() - inactive * self.n_layers


def _ffn_params(cfg: "ModelConfig") -> int:
    """Parameters of one layer's FFN (MoE: router, every expert, the
    shared experts and the dense residual)."""
    d = cfg.d_model
    if cfg.moe is not None:
        m = cfg.moe
        p = d * m.n_experts + m.n_experts * 3 * d * m.d_ff_expert
        if m.n_shared_experts:
            p += 3 * d * m.d_ff_shared
        if m.d_ff_dense_residual:
            p += 3 * d * m.d_ff_dense_residual
        return p
    return 3 * d * cfg.d_ff


def _layer_params(cfg: "ModelConfig", kind: str) -> int:
    """Parameters of one layer of ``kind``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qkv = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if kind in ("attn", "local"):
        return qkv + _ffn_params(cfg) + 2 * d
    if kind == "cross":
        return qkv + _ffn_params(cfg) + 3 * d + 2
    if kind == "selfcross":
        return 2 * qkv + _ffn_params(cfg) + 3 * d
    if kind == "rglru":
        r = cfg.rglru
        w = r.lru_width
        return (2 * d * w + r.conv_width * w + 2 * w * w + w
                + w * d + _ffn_params(cfg) + 2 * d)
    if kind == "ssd":
        s = cfg.ssm
        di, h = s.d_inner(d), s.n_heads(d)
        proj_in = d * (2 * di + 2 * s.d_state + h)
        return (proj_in + s.conv_width * (di + 2 * s.d_state)
                + 3 * h + di + di * d + d)
    raise ValueError(kind)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


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


def list_configs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # importing the package registers every config module
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
