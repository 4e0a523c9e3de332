"""Suffix prefill after a radix prefix hit (the JAX package's
``serving/prefill.py`` ``suffix_prefill``).  The prefill cluster's
``PrefillWorker`` is not ported yet."""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import decode_step


def suffix_prefill(params, cfg: ModelConfig, prompt: Sequence[int],
                   row_cache: List[dict], start: int):
    """Prefill only ``prompt[start:]`` on top of a one-request cache that
    already holds the first ``start`` tokens' KV (a radix prefix hit):
    the shared prefix is not recomputed.  The suffix runs as successive
    ``decode_step``s on the B = 1 row, which write their K/V into
    ``row_cache`` in place.  Returns ``(last_logits (1, V), row_cache)``.
    """
    if not start < len(prompt):
        raise ValueError(f"suffix start {start} leaves no token of a "
                         f"{len(prompt)}-token prompt")
    dev = params["embed"].device
    toks = torch.tensor(list(prompt[start:]), dtype=torch.int64, device=dev)
    pos = torch.arange(start, len(prompt), dtype=torch.int32, device=dev)
    logits = None
    for i in range(toks.shape[0]):
        logits, row_cache = decode_step(params, cfg, toks[i:i + 1], row_cache,
                                        pos[i:i + 1])
    return logits, row_cache
