"""The disaggregated runtime on disjoint groups of gloo ranks of the CPU
(``launch.mesh.ServingRoles``, ``MultiControllerTransport.setup_serving``)
against the JAX runtime on the same split of forced host devices
(``tests/_torch_disagg_ref.py``), the cases of
``tests/test_multidevice.py`` on reduced mixtral:

  * one decode step of the runtime (m = 2) on 1 attention + 2 expert and
    on 2 + 2 ranks, and of a dense model (granite: each expert rank its
    column block of the FFN, the partial outputs summed in the N2M hop)
    on 1 + 2: each attention rank's rows of the logits within 3e-4
    of JAX's disaggregated and monolithic steps (that test's tolerance),
    the greedy tokens exact, the expert ranks without logits, the merged
    stage report the same on every rank;
  * the ping-pong engine with m = 2 through M2N on 2 + 2 ranks: tokens
    equal to JAX's ping-pong and monolithic engines' and to the port's
    one-process engine's, stage counts above 0, the merged stats the same
    on every rank, the ledger's tokens / collective hops and bytes those
    of one process;
  * zipf(1.2) rebalancing every 2 decode iterations over 4 expert ranks
    (1 + 4), with and without M2N: tokens equal to the static run's and to
    JAX's, rebalances, at least one replicated expert, an imbalance below
    the static run's and equal to JAX's, the expert loads JAX's.

A rank draws only what its role keeps (``launch.serve.draw_for_rank``
through ``core.disagg.rank_place``): equal, leaf for leaf, to what
``rank_params`` keeps of a whole draw, on every rank of each layout.
"""
import pickle

import numpy as np
import pytest
import torch

import _torch_disagg as td

torch.set_num_threads(1)

STEP = dict(kind="step", max_seq=16,
            tokens=np.random.RandomState(1).randint(0, 512, (4, 8)).astype(np.int64))
SPLITS = {"1x2": (1, 2), "2x2": (2, 2), "dense-1x2": (1, 2)}
DENSE = "granite-3-8b"
X4 = dict(attn_ranks=[0], expert_ranks=[1, 2, 3, 4])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    pj = td.jax_params()
    base = dict(td.ENGINE, kind="engine", prompts=td.prompts(5), max_new=4)
    zipf = dict(td.ENGINE, kind="engine", prompts=td.prompts(6), max_new=5, zipf=1.2)
    jax_cases = [dict(STEP, name=f"step-{k}", attn=a, expert=x,
                      **({"arch": DENSE} if k.startswith("dense") else {}))
                 for k, (a, x) in SPLITS.items()]
    jax_cases += [dict(base, name="mono", mode="mono"),
                  dict(base, name="pp", mode="pingpong", attn=2, expert=2, m2n=True),
                  dict(zipf, name="static", mode="pingpong", attn=1, expert=4),
                  dict(zipf, name="reb", mode="pingpong", attn=1, expert=4, rebalance=2),
                  dict(zipf, name="reb-m2n", mode="pingpong", attn=1, expert=4,
                       rebalance=2, m2n=True)]
    ranked = {3: [dict(STEP, name="step-1x2", params=pj),
                  dict(STEP, name="step-dense-1x2", arch=DENSE,
                       params=td.jax_params(DENSE))],
              4: [dict(STEP, name="step-2x2", params=pj),
                  dict(base, name="pp", m2n=True, params=pj)],
              5: [dict(zipf, **X4, name=n, params=pj, **kw)
                  for n, kw in (("static", {}), ("reb", dict(rebalance=2)),
                                ("reb-m2n", dict(rebalance=2, m2n=True)))]}
    want, got = td.run(tmp_path_factory.mktemp("disagg"), jax_cases,
                       list(ranked.items()))
    one = {"pp": td.one_process(pj, dict(base, m2n=True, expert_ranks=(2, 3))),
           "static": td.one_process(pj, dict(zipf, **X4))}
    return want, got, one


@pytest.mark.parametrize("arch,world,prefill,kw", [
    ("mixtral-8x22b", 5, 0, dict(attn_ranks=[0], expert_ranks=[1, 2, 3, 4])),
    ("mixtral-8x22b", 4, 1, {}),
    ("granite-3-8b", 3, 0, {})])
@pytest.mark.parametrize("m2n", [False, True])
def test_rank_place_draws_what_rank_params_keeps(arch, world, prefill, kw, m2n):
    from repro_torch.config import get_config, reduced
    from repro_torch.core.disagg import rank_params, rank_place
    from repro_torch.launch.mesh import ServingRoles
    from repro_torch.launch.serve import draw_params
    from repro_torch.serving.config import ServingConfig
    from repro_torch.training.optimizer import named_leaves
    cfg = reduced(get_config(arch))
    moe = cfg.moe is not None
    sc = ServingConfig(arch=arch, use_m2n=m2n and moe, prefill_devices=prefill,
                       zipf_route_bias=1.2 if moe else 0.0, seed=3)
    roles = ServingRoles(world, prefill, **kw)
    whole = draw_params(sc, cfg, "cpu")
    for rank in range(world):
        rk = dict(use_m2n=sc.use_m2n, inline_prefill=not prefill)
        want = dict(named_leaves(rank_params(cfg, whole, roles, rank, **rk)))
        placed = draw_params(sc, cfg, "cpu", place=rank_place(cfg, roles, rank, **rk))
        got = dict(named_leaves(rank_params(cfg, placed, roles, rank, **rk)))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), (roles.role(rank), rank)


def same_on_every_rank(results, key):
    first = pickle.dumps(results[0][key])
    return all(pickle.dumps(r[key]) == first for r in results)


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_decode_step_on_ranks_matches_jax(runs, split):
    want, got, _ = runs
    w, ranks = want[f"step-{split}"], got[f"step-{split}"]
    a, x = SPLITS[split]
    assert [r["role"] for r in ranks] == ["attn"] * a + ["expert"] * x
    covered = []
    for r, res in enumerate(ranks):
        assert np.array_equal(res["nxt"], w["nxt"]), (split, r)
        if res["role"] == "expert":
            assert res["logits"] is None and res["rows"] is None
            continue
        lo, hi = res["rows"]
        covered += list(range(lo, hi))
        for ref in ("disagg", "mono"):
            np.testing.assert_allclose(res["logits"], w[ref][lo:hi], rtol=3e-4,
                                       atol=3e-4, err_msg=f"{split} rank {r} {ref}")
        assert np.array_equal(res["logits"].argmax(-1), w["disagg"][lo:hi].argmax(-1))
    assert covered == list(range(4))
    assert same_on_every_rank(ranks, "stages")
    st = ranks[0]["stages"]
    assert st["attn_n"] == st["expert_n"] == st["m2n_n"] == st["n2m_n"] == 4
    assert [r["role"] for r in st["ranks"]] == ["attn"] * a + ["expert"] * x


def test_pingpong_engine_on_ranks_is_token_identical(runs):
    want, got, one = runs
    ranks = got["pp"]
    one_toks, one_st = one["pp"]
    assert want["pp"]["tokens"] == want["mono"]["tokens"]
    for res in ranks:
        assert res["tokens"] == want["pp"]["tokens"] == one_toks
    assert same_on_every_rank(ranks, "stats")
    st = ranks[0]["stats"]
    assert st["stages"]["attn_n"] > 0 and st["stages"]["expert_n"] > 0
    for k in ("attn_n", "expert_n", "m2n_n", "n2m_n"):
        assert st["stages"][k] == want["pp"]["stats"]["stages"][k] == one_st["stages"][k]
    assert st["transport"]["backend"] == "multi"
    for kind in ("tokens", "collective"):
        for k in ("hops", "bytes"):
            assert st["transport"][kind][k] == one_st["transport"][kind][k], (kind, k)
    assert [r["role"] for r in st["ranks"]] == ["attn", "attn", "expert", "expert"]
    # the attention ranks send and account the hops, the expert ranks wait
    for r in st["ranks"][2:]:
        assert r["transport"]["tokens"]["hops"] == 0
        assert r["transport"]["tokens"]["waits"] > 0


@pytest.mark.parametrize("m2n", [False, True], ids=["dispatch", "m2n"])
def test_rebalancing_on_ranks_matches_jax(runs, m2n):
    want, got, one = runs
    name = "reb-m2n" if m2n else "reb"
    static = got["static"][0]["stats"]
    assert want[name]["tokens"] == want["static"]["tokens"] == one["static"][0]
    for res in got[name] + got["static"]:
        assert res["tokens"] == want["static"]["tokens"]
    assert same_on_every_rank(got[name], "stats")
    st = got[name][0]["stats"]
    assert st["rebalances"] > 0 and st["replicated_experts"] >= 1, st
    assert st["imbalance"] < static["imbalance"]
    assert abs(st["imbalance"] - want[name]["stats"]["imbalance"]) < 1e-9
    assert st["expert_loads"] == want[name]["stats"]["expert_loads"]
    assert st["replicated_experts"] == want[name]["stats"]["replicated_experts"]
    assert st["transport"]["weights"]["bytes"] > 0
