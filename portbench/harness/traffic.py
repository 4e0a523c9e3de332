"""The general traffic generator: one function reads a traffic file's
parameters and makes every request of a run from ``--seed``.

Every seed gets the same sizes in another order.  Request lengths are
drawn in blocks of ``block`` requests: each block holds the ``block``
quantiles of the length distribution (its inverse CDF at (i + 0.5) /
block), shuffled by the seed, prompt and output lengths each with a
shuffle of its own.  A window that takes a few blocks then holds nearly
the same multiset of lengths whatever the seed, so the seed changes the
order and the token ids, not the amount of work.

Request k is the k-th request submitted in the run, whichever client
sends it.  The first ``clients`` requests are the in-flight start: they
are admitted during set-up, each with a remaining output drawn from the
``start.output`` distribution (quantiles of it, shuffled), so that their
completions, and so the admissions that follow, spread evenly over the
window from its start instead of arriving as one wave.  ``residual`` of
the output distribution is the steady state's: a closed loop that has
run a long time finds a request in flight with r tokens still to come
with probability P(L >= r) / E[L], so from the first step the requests
finish at the steady rate, clients / E[L] a step.

Token ids are drawn per request from a generator keyed by (seed, k), so
a request's prompt does not depend on how many requests came before it.

Distributions (``dist``):
  exponential  ``mean``: an exponential truncated to [min, max] (not
               clipped: no mass piles up at a bound) whose scale is solved
               so that its mean is ``mean``, rounded; the one-parameter
               shape for a source that publishes a mean length
  residual     the remaining length of a request in flight in the steady
               state of the traffic's ``of`` distribution (see above)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np


def truncated_exp_mean(lo: float, hi: float, scale: float) -> float:
    """The mean of an exponential of ``scale`` truncated to [lo, hi]."""
    w = hi - lo
    return lo + scale - w / math.expm1(w / scale)


def truncated_exp_scale(lo: float, hi: float, mean: float) -> float:
    """The scale whose exponential truncated to [lo, hi] has ``mean``
    (bisection: the mean rises from lo to the midpoint with the scale)."""
    if not lo < mean < (lo + hi) / 2:
        raise ValueError(f"mean {mean} outside ({lo}, {(lo + hi) / 2})")
    a, b = (hi - lo) / 500, 1e6 * (hi - lo)
    for _ in range(200):
        m = math.sqrt(a * b)
        if truncated_exp_mean(lo, hi, m) < mean:
            a = m
        else:
            b = m
    return math.sqrt(a * b)


def quantiles(dist: dict, u: np.ndarray) -> np.ndarray:
    """The distribution's inverse CDF at each u in (0, 1), as whole numbers."""
    kind = dist["dist"]
    if kind == "exponential":
        lo, hi = float(dist["min"]), float(dist["max"])
        scale = truncated_exp_scale(lo, hi, float(dist["mean"]))
        v = lo - scale * np.log1p(-np.asarray(u) * -math.expm1(-(hi - lo) / scale))
        return np.clip(np.round(v), lo, hi).astype(np.int64)
    raise ValueError(f"unknown distribution {kind!r}")


def strata(dist: dict, n: int) -> np.ndarray:
    """The n quantiles of ``dist`` at (i + 0.5) / n."""
    return quantiles(dist, (np.arange(n) + 0.5) / n)


def residual_strata(of: dict, n: int, fine: int = 1 << 14) -> np.ndarray:
    """The n quantiles of the steady-state remaining length of ``of``:
    P(R = r) = P(L >= r) / E[L] for r >= 1."""
    counts = np.bincount(strata(of, fine))
    at_least = np.cumsum(counts[::-1])[::-1][1:]          # #(L >= r), r >= 1
    cdf = np.cumsum(at_least) / at_least.sum()
    u = (np.arange(n) + 0.5) / n
    return (np.searchsorted(cdf, u) + 1).astype(np.int64)


@dataclass
class Request:
    index: int          # k: the k-th request of the run
    prompt: List[int]
    max_new_tokens: int


class Traffic:
    """The requests of one run: ``request(k)`` is the k-th submitted."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        if spec.get("loop") != "closed":
            raise ValueError(f"the generator drives closed loops, not "
                             f"{spec.get('loop')!r}")
        if spec.get("shared_prefix", 0):
            raise ValueError("shared prefixes are not generated yet")
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.clients = int(spec["clients"])
        self.block = int(spec["block"])
        ids = spec.get("ids", {"dist": "uniform"})
        if ids["dist"] != "uniform":
            raise ValueError(f"token ids: {ids['dist']!r}")
        self._prompt = strata(spec["prompt"], self.block)
        self._output = strata(spec["output"], self.block)
        start = spec["start"]["output"]
        self._start = (residual_strata(spec[start["of"]], self.clients)
                       if start["dist"] == "residual"
                       else strata(start, self.clients))
        self._start_order = np.random.default_rng(
            [self.seed, 1]).permutation(self.clients)
        self._perm = {}

    def _block_perm(self, which: int, b: int) -> np.ndarray:
        key = (which, b)
        if key not in self._perm:
            self._perm[key] = np.random.default_rng(
                [self.seed, 2 + which, b]).permutation(self.block)
        return self._perm[key]

    def prompt_len(self, k: int) -> int:
        b, i = divmod(k, self.block)
        return int(self._prompt[self._block_perm(0, b)[i]])

    def output_len(self, k: int) -> int:
        if k < self.clients:
            return int(self._start[self._start_order[k]])
        b, i = divmod(k - self.clients, self.block)
        return int(self._output[self._block_perm(1, b)[i]])

    def request(self, k: int) -> Request:
        rng = np.random.default_rng([self.seed, 0, k])
        prompt = rng.integers(0, self.vocab, size=self.prompt_len(k)).tolist()
        return Request(index=k, prompt=prompt, max_new_tokens=self.output_len(k))
