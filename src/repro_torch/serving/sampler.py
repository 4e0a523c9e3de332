"""Token sampling for the serving engine.

Greedy decoding (temperature 0) is the path held to the JAX package
token for token.  Temperature sampling draws with ``torch.Generator``s,
so it cannot reproduce ``jax.random`` bits; it keeps the property that
matters to serving: a request's sampled tokens depend on the engine's
seed stream and the request id only, never on which KV row it occupies.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_MASK63 = (1 << 63) - 1


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 0 => disabled
    top_p: float = 1.0


def _filtered_logits(logits: torch.Tensor, params: SamplingParams):
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -params.top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < params.top_p).sum(-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample(logits: torch.Tensor, seed: int,
           params: SamplingParams = SamplingParams()) -> torch.Tensor:
    """logits: (B, V) -> token ids (B,) int64.  Greedy ignores ``seed``."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    gen = torch.Generator(device=logits.device).manual_seed(seed & _MASK63)
    probs = torch.softmax(_filtered_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def fold_seed(seed: int, row_id: int) -> int:
    """Mix a row id into a seed (splitmix64 finalizer)."""
    z = (seed + 0x9E3779B97F4A7C15 * (row_id + 1)) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def sample_rows(logits: torch.Tensor, seed: int, row_ids,
                params: SamplingParams = SamplingParams()) -> torch.Tensor:
    """Placement-independent batch sampling: row i draws with the seed
    ``fold_seed(seed, row_ids[i])``, so a request's tokens do not depend
    on its batch row."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.cat([sample(logits[i:i + 1], fold_seed(seed, int(r)), params)
                      for i, r in enumerate(row_ids)])
