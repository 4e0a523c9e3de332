"""The general traffic generator: deterministic from the seed, the same
sizes for every seed, and a start that is already in steady state."""
from collections import Counter

import numpy as np
import portbench_tiny  # noqa: F401
import pytest
from harness.spec import PORTBENCH, load_json
from harness.traffic import (Traffic, quantiles, strata, truncated_exp_mean,
                              truncated_exp_scale)

CHAT = load_json(PORTBENCH / "traffic" / "chat-c128.json")
BIG = 3_000_000_017                   # past 32 signed bits


def test_same_seed_same_requests():
    a, b = Traffic(CHAT, BIG, 32000), Traffic(CHAT, BIG, 32000)
    for k in (0, 1, 127, 128, 500):
        ra, rb = a.request(k), b.request(k)
        assert ra.prompt == rb.prompt and ra.max_new_tokens == rb.max_new_tokens
    c = Traffic(CHAT, BIG + 1, 32000)
    assert a.request(200).prompt != c.request(200).prompt


def test_every_seed_same_sizes_in_another_order():
    block = CHAT["block"]
    lens = {}
    for seed in (1, 2, BIG):
        t = Traffic(CHAT, seed, 32000)
        ks = range(CHAT["clients"], CHAT["clients"] + 4 * block)
        lens[seed] = ([t.prompt_len(k) for k in ks], [t.output_len(k) for k in ks])
    assert Counter(lens[1][0]) == Counter(lens[2][0]) == Counter(lens[BIG][0])
    assert Counter(lens[1][1]) == Counter(lens[BIG][1])
    assert lens[1][0] != lens[2][0]


def test_lengths_follow_the_file():
    """The published means (ShareGPT, vLLM's Fig. 11) within the
    published bounds, with no mass piled at a bound."""
    for key, mean in (("prompt", 161.31), ("output", 337.99)):
        d = CHAT[key]
        assert d["mean"] == mean
        x = strata(d, 4096)
        assert x.min() >= 4 and x.max() <= 1024
        assert x.mean() == pytest.approx(mean, rel=2e-3)
        assert (x == x.max()).sum() <= 2
        assert strata(d, CHAT["block"]).mean() == pytest.approx(mean, rel=0.01)
    assert CHAT["prompt"]["max"] + CHAT["output"]["max"] <= CHAT["engine"]["max_seq"]
    assert quantiles(CHAT["output"], np.array([1e-9, 1 - 1e-9])).tolist() == [4, 1024]
    with pytest.raises(ValueError):
        quantiles({"dist": "pareto"}, np.array([0.5]))


@pytest.mark.parametrize("lo,hi,mean", [(4, 1024, 161.31), (4, 1024, 337.99),
                                        (1, 10, 3.0), (64, 512, 250.0)])
def test_truncated_exponential_has_the_asked_mean(lo, hi, mean):
    scale = truncated_exp_scale(lo, hi, mean)
    assert truncated_exp_mean(lo, hi, scale) == pytest.approx(mean, rel=1e-9)
    u = (np.arange(200_000) + 0.5) / 200_000
    w = hi - lo
    v = lo - scale * np.log1p(-u * -np.expm1(-w / scale))
    assert v.mean() == pytest.approx(mean, rel=1e-4)
    with pytest.raises(ValueError):
        truncated_exp_scale(lo, hi, (lo + hi) / 2)


def test_start_is_steady_state():
    """The in-flight start's remaining outputs are the steady state's
    residual lengths, P(R = r) = P(L >= r) / E[L]: their mean is
    E[L^2] / 2E[L] (~271 for the output lengths, not 338), and requests
    finish at the steady rate clients / E[L] a step from the first."""
    t = Traffic(CHAT, BIG, 32000)
    rem = np.array(sorted(t.output_len(k) for k in range(CHAT["clients"])))
    L = strata(CHAT["output"], 1 << 14).astype(np.float64)
    assert rem.mean() == pytest.approx((L ** 2).mean() / (2 * L.mean()), rel=0.02)
    assert rem.min() >= 1 and rem.max() <= 1024
    steps = 64                       # requests the first 64 steps finish
    expect = CHAT["clients"] * sum((L >= r).mean() for r in range(1, steps + 1)) / L.mean()
    assert (rem <= steps).sum() == pytest.approx(expect, abs=2)
    assert len({t.output_len(k) for k in range(CHAT["clients"])}) > 100


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_token_ids_in_vocab(seed):
    t = Traffic(CHAT, seed, 32000)
    ids = np.concatenate([t.request(k).prompt for k in range(50)])
    assert ids.min() >= 0 and ids.max() < 32000
