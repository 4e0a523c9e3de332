"""Faults planted in the timed path, each of which has to turn a run's
``correct`` false: the faults a serving cell on one card can have.

``plant(name)`` patches the port in this process and returns a function
that undoes it.  ``tests/test_portbench_faults.py`` plants each on the
CPU at a tiny size; ``control.py --fault <name>`` plants one at a cell's
own size on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple


def state_unchanged(orig):
    """The decode step attends over a copy of the cache: the step's new
    K / V never reaches the request's state."""
    return lambda p, cfg, x, pos, cache, window: orig(
        p, cfg, x, pos, {k: v.clone() for k, v in cache.items()}, window)


def half_batch(orig):
    """Half of the batch left out: its rows get the mean of the other
    half's logits."""
    def decode(self, tokens, cache, pos, mb_slices=None):
        logits, cache = orig(self, tokens, cache, pos, mb_slices)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h].float().mean(0).to(logits.dtype)
        return logits, cache
    return decode


def no_exchange(orig):
    """The experts' return hop left out: the combine sees zeros."""
    import torch

    def combine(self, p, x, h, out, disp):
        return orig(self, p, x, h, torch.zeros_like(out), disp)
    return combine


def altered_token(orig):
    """Every fourth step's tokens altered where they are sampled."""
    calls = [0]

    def sample_rows(logits, seed, rids, params):
        t = orig(logits, seed, rids, params)
        calls[0] += 1
        V = logits.shape[-1]
        return (t + V // 2) % V if calls[0] % 4 == 0 else t
    return sample_rows


def targets() -> Dict[str, Tuple[object, str, Callable]]:
    """name -> (owner, attribute, wrapper of the original)."""
    import repro_torch.core.disagg as dg
    import repro_torch.serving.engine as en
    return {"state_unchanged": (dg, "self_attn_decode_sublayer", state_unchanged),
            "half_batch": (dg.DisaggregatedInstance, "decode_microbatched", half_batch),
            "no_exchange": (dg.DisaggregatedInstance, "_combine_phase", no_exchange),
            "altered_token": (en, "sample_rows", altered_token)}


NAMES = ("state_unchanged", "half_batch", "no_exchange", "altered_token")


def plant(name: str) -> Callable[[], None]:
    owner, attr, make = targets()[name]
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    return lambda: setattr(owner, attr, orig)
