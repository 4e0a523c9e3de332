"""The kernels' work counts against counts by hand, at both
configurations' shapes: needed work only, idle experts and padded rows
and empty ring slots counting for nothing."""
import types

import numpy as np
import portbench_tiny  # noqa: F401
import pytest
import torch
from harness import peaks
from harness.spec import PORTBENCH, load_json, work_module

GMM = work_module("grouped_matmul")
ATT = work_module("decode_attention")
MIXTRAL = load_json(PORTBENCH / "configs" / "mixtral-8x22b-8L.json")
ARCTIC = load_json(PORTBENCH / "configs" / "arctic-480b-2L.json")


def route_log(counts, K, N, E, C=64):
    return [("route", torch.tensor(counts, dtype=torch.float32)),
            ("grouped_matmul", (E, C, K), N, 2)]


def test_grouped_matmul_mixtral_every_expert_hit():
    d, f = MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"]
    counts = [16] * 8                                  # 64 rows x top-2
    (flops, nbytes), = GMM.need(route_log(counts, d, f, 8), None)
    assert flops == 2 * 128 * d * f
    # the 8 experts' (6144 x 16384) weights + 128 routed rows in and out
    assert nbytes == 2 * (8 * d * f + 128 * (d + f))
    assert nbytes == pytest.approx(1.616e9, rel=1e-3)
    # memory-bound: the bound is the bytes'
    assert peaks.bound_s(flops, nbytes, "bfloat16") == nbytes / peaks.BYTES_PER_S


def test_grouped_matmul_arctic_counts_only_routed_experts():
    d, f, E = ARCTIC["hidden_size"], ARCTIC["intermediate_size"], 128
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, E, size=128)               # 64 rows x top-2
    counts = np.bincount(pairs, minlength=E).astype(float)
    hit = int((counts > 0).sum())
    assert 60 < hit < 100                              # ~63% of 128 hold a token
    (_, nbytes), = GMM.need(route_log(counts.tolist(), d, f, E), None)
    assert nbytes == 2 * (hit * d * f + 128 * (d + f))
    full = 2 * E * d * f                               # what a full read streams
    assert nbytes / full == pytest.approx(hit / E, rel=1e-3)
    # the down projection of the same routing: K and N swap
    (_, down), = GMM.need(route_log(counts.tolist(), f, d, E), None)
    assert down == nbytes


def test_grouped_matmul_pairs_each_launch_with_its_routing():
    log = (route_log([2, 0, 0, 0], 8, 16, 4) + [("grouped_matmul", (4, 64, 8), 16, 2)]
           + route_log([0, 0, 1, 1], 8, 16, 4))
    needs = GMM.need(log, None)
    assert [n[1] for n in needs] == [2 * (1 * 128 + 2 * 24)] * 2 + [2 * (2 * 128 + 2 * 24)]
    with pytest.raises(ValueError):
        GMM.need([("grouped_matmul", (4, 64, 8), 16, 2)], None)


def test_decode_attention_counts_valid_positions():
    H, Hkv, hd = (MIXTRAL["num_attention_heads"], MIXTRAL["num_key_value_heads"],
                  MIXTRAL["head_dim"])
    rows = np.zeros(128, np.int64)
    rows[:64] = 300                                     # micro-batch 0
    rows[64:100] = 1000                                 # micro-batch 1, 28 idle
    run = types.SimpleNamespace(mb_slices=[slice(0, 64), slice(64, 128)],
                                step_rows=lambda i: rows)
    log = [("step", 0)] + [("decode_attention", 64, H, Hkv, hd, 2)] * 4
    needs = ATT.need(log, run)
    assert len(needs) == 4
    v0, v1 = 64 * 300, 36 * 1000
    assert needs[0] == (4 * H * hd * v0, 2 * (2 * Hkv * hd * v0 + 2 * 64 * H * hd))
    assert needs[1] == (4 * H * hd * v1, 2 * (2 * Hkv * hd * v1 + 2 * 64 * H * hd))
    assert needs[2] == needs[0] and needs[3] == needs[1]
    bad = [("step", 0), ("decode_attention", 32, H, Hkv, hd, 2)]
    with pytest.raises(ValueError):
        ATT.need(bad, run)


def test_model_flops_per_token():
    step = work_module("model_step")
    lin = step.per_token_linear(MIXTRAL)
    assert lin == pytest.approx(1.384e9, rel=1e-3)
    one = types.SimpleNamespace(admitted=[], rows={0: 1})
    L, d, V = 8, 6144, 32000
    assert step.step_flops(MIXTRAL, [one]) == L * (lin + 4 * 48 * 128) + 2 * d * V
    arctic = step.per_token_linear(ARCTIC)
    # 2·7168·(56 + 16)·128 + 2·7168² projections, 2·7168·128 router,
    # 2 x 6·7168·4864 routed, 6·7168² the residual MLP at its published width
    assert arctic == pytest.approx(0.9634e9, rel=2e-3)


def test_roofline_share():
    from harness.trace import roofline

    class Tr:
        log = [("x",)]

        def kernel_seconds(self, names):
            return 2e-3, 3

    work = types.SimpleNamespace(KERNEL_NAMES=("k",),
                                 need=lambda log, run: [(0.0, 3.35e9)])
    assert roofline(Tr(), work, None, "bfloat16") == pytest.approx(50.0)
    assert roofline(None, work, None, "bfloat16") is None
