"""The end-to-end metrics of one measured window, from the benchmark's own
records of the closed loop (``harness.serve``).

  output_tok_s  every token emitted in the window, first tokens included,
                over the window's seconds (its first step's start to its
                last step's end)
  itl_p95_ms    95th percentile over every gap between two consecutive
                tokens of one request whose later token came in the
                window, across all requests (the two tokens of an
                admission step come together: a gap of 0)
  ttft_p90_ms   90th percentile, over the requests submitted in the
                window, of submission to the end of the step that gave
                their first token (a window completes 145-170 requests:
                the highest percentile with ten samples past it)
  peak_mem_gib  read by the caller from the device

A tail is taken over all of the window's samples, with numpy's linear
interpolation between order statistics.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def percentile(values: List[float], q: float) -> float:
    if not values:
        raise ValueError("no samples in the window")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def token_gaps(flights, t_start: float, t_end: float) -> List[float]:
    gaps = []
    for f in flights:
        for a, b in zip(f.times, f.times[1:]):
            if t_start < b <= t_end:
                gaps.append(b - a)
    return gaps


def ttfts(flights, t_start: float, t_end: float) -> List[float]:
    return [f.times[0] - f.t_submit for f in flights
            if f.t_submit >= t_start and f.times and f.times[0] <= t_end]


def end_to_end(steps, flights, t_start: float, t_end: float) -> Dict[str, float]:
    seconds = t_end - t_start
    tokens = sum(s.tokens for s in steps)
    return {"output_tok_s": tokens / seconds,
            "itl_p95_ms": 1e3 * percentile(token_gaps(flights, t_start, t_end), 95),
            "ttft_p90_ms": 1e3 * percentile(ttfts(flights, t_start, t_end), 90)}


def counts(steps, flights, t_start: float, t_end: float) -> Dict[str, float]:
    """The window's counts, and beside the metrics' own tails the
    neighbouring percentiles (for the record, not compared)."""
    gaps, firsts = token_gaps(flights, t_start, t_end), ttfts(flights, t_start, t_end)
    out = {"steps": len(steps), "tokens": sum(s.tokens for s in steps),
           "admitted": sum(len(s.admitted) for s in steps),
           "gaps": len(gaps), "ttft_samples": len(firsts)}
    for name, vals in (("itl", gaps), ("ttft", firsts)):
        for q in (50, 90, 95):
            if vals:
                out[f"{name}_p{q}_ms"] = round(1e3 * percentile(vals, q), 3)
    return out
