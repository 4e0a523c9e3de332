"""Synthetic LM data pipeline, a copy of the JAX package's
``training/data.py`` (numpy only): the same seed gives the same
batches, bit for bit.

Deterministic, seedable, infinite stream of token batches with learnable
structure (a mixture of Zipf-distributed unigrams and copied n-gram
motifs), packed into rows with EOS separators.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    eos_id: int = 1
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.5
    mean_doc_len: int = 96


class SyntheticLM:
    """Infinite iterator of (batch, seq_len) int32 token arrays."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        base = self.rng.zipf(cfg.zipf_a, size=cfg.n_motifs * cfg.motif_len)
        self.motifs = (base % (cfg.vocab - 2) + 2).reshape(
            cfg.n_motifs, cfg.motif_len).astype(np.int32)

    def _document(self) -> np.ndarray:
        cfg = self.cfg
        length = max(4, int(self.rng.exponential(cfg.mean_doc_len)))
        out = []
        while len(out) < length:
            if self.rng.rand() < cfg.motif_prob:
                out.extend(self.motifs[self.rng.randint(cfg.n_motifs)])
            else:
                n = self.rng.randint(1, cfg.motif_len)
                toks = self.rng.zipf(cfg.zipf_a, size=n) % (cfg.vocab - 2) + 2
                out.extend(toks.astype(np.int32))
        return np.asarray(out[:length], np.int32)

    def _packed_row(self) -> np.ndarray:
        cfg = self.cfg
        row = np.empty(cfg.seq_len, np.int32)
        i = 0
        while i < cfg.seq_len:
            doc = self._document()
            n = min(len(doc), cfg.seq_len - i)
            row[i:i + n] = doc[:n]
            i += n
            if i < cfg.seq_len:
                row[i] = cfg.eos_id
                i += 1
        return row

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield np.stack([self._packed_row()
                            for _ in range(self.cfg.batch)])

    def batches(self, n: int):
        it = iter(self)
        return [next(it) for _ in range(n)]
