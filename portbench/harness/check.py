"""What decides ``correct``: the served tokens of the timed window held
against the plain reference.

Once the window has closed, its memory read and the program's state
freed, a sample of the requests the window submitted is drawn from the
seed, finished or still running at its close (those with the tokens
served so far: a request with a long output that the window submitted
never finishes in it, and its late positions are the longest KV reads
of the window): the longest of them, then requests from each
micro-batch's rows in turn until the sample holds ``sample_tokens``
served tokens and at least ``per_group`` requests of every micro-batch.
The reference (``portbench/reference/<name>.py``, float32) runs once over
each prompt with its served tokens, on weights it draws again itself
from the seed, and every served token is read against it: the gap by
which its reference logit lies below the reference's best at that
position.  The mean gap over the sample's served tokens is the number
compared; the cell's check file gives its limit.  Under greedy sampling
a token the program served correctly reads a gap of the program's
rounding only: 0 where rounding did not change the first token, and
rarely O(1) where a near tie of the router's top-k (or of the logits)
fell the other way in bf16.  Such flips make the widest gap swing from
seed to seed, and the mean, over about a thousand tokens, does not.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def window_requests(flights, t_start: float, t_end: float):
    """Requests submitted in the window that were served a token in it,
    finished or not."""
    return [f for f in flights if f.t_submit >= t_start
            and f.times and f.times[0] <= t_end]


def sample(cands, seed: int, group_of, n_groups: int, sample_tokens: int,
           per_group: int) -> List:
    if not cands:
        return []
    rng = np.random.default_rng([seed, 7])
    longest = max(cands, key=lambda f: (len(f.req.generated), -f.k))
    groups = [[] for _ in range(n_groups)]
    for f in cands:
        if f is not longest:
            groups[group_of(f.slot)].append(f)
    for g in groups:
        rng.shuffle(g)
    picked, count = [longest], [0] * n_groups
    count[group_of(longest.slot)] += 1
    tokens = len(longest.req.generated)
    g = 0
    while any(groups) and (tokens < sample_tokens
                           or any(c < per_group and groups[i]
                                  for i, c in enumerate(count))):
        if groups[g]:
            f = groups[g].pop()
            picked.append(f)
            count[g] += 1
            tokens += len(f.req.generated)
        g = (g + 1) % n_groups
    return picked


def sequences(picked) -> List[List[int]]:
    """Each prompt with its served tokens but the last (whose logits no
    served token reads)."""
    return [list(f.req.prompt) + list(f.req.generated[:-1]) for f in picked]


def served_positions(f):
    """(positions, tokens): the logits row of each served token."""
    p = len(f.req.prompt)
    return (list(range(p - 1, p - 1 + len(f.req.generated))),
            list(f.req.generated))


def gaps_of(torch, ref_logits, picked) -> np.ndarray:
    """Per served token: reference best minus reference logit of the token."""
    out = []
    for L, f in zip(ref_logits, picked):
        pos, tok = served_positions(f)
        rows = L[torch.tensor(pos, device=L.device)]
        got = rows.gather(1, torch.tensor(tok, device=L.device)[:, None])[:, 0]
        out.append((rows.max(dim=1).values - got).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps_of(torch, ref_logits, low_logits, picked) -> np.ndarray:
    """Per served position: the reference's gap of the token the lower
    precision would put first there."""
    out = []
    for L, C, f in zip(ref_logits, low_logits, picked):
        pos, _ = served_positions(f)
        idx = torch.tensor(pos, device=L.device)
        rows, first = L[idx], C[idx].argmax(dim=1)
        got = rows.gather(1, first[:, None])[:, 0]
        out.append((rows.max(dim=1).values - got).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def summary(gaps: np.ndarray) -> Dict[str, float]:
    """The readings of a set of per-token gaps: the compared mean, and
    beside it the share above zero, the 99th percentile and the widest."""
    if not gaps.size:
        return {"mean_logit_gap": float("inf")}
    return {"mean_logit_gap": float(gaps.mean()),
            "share_off_best": float((gaps > 0).mean()),
            "p99_logit_gap": float(np.percentile(gaps, 99)),
            "max_logit_gap": float(gaps.max())}


def malformed(flights, vocab: int) -> int:
    """Requests whose served tokens are not ids of the vocabulary."""
    return sum(1 for f in flights
               if any(not 0 <= t < vocab for t in f.req.generated))


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in readings and readings[k] <= lim for k, lim in limits.items())
