"""Serving through the disaggregated runtime on gloo ranks of the CPU,
the cases of ``tests/test_multidevice.py`` that place prefill and KV
against the JAX engine on the same split of forced host devices
(``tests/_torch_disagg_ref.py``), on reduced mixtral:

  * 1 prefill + 1 attention + 2 expert ranks, m = 2 through M2N, KV moved
    from the prefill rank under sync and async transfer: tokens equal to
    JAX's engine on the same split and to its monolithic engine,
    ``transfer_n`` 5, ``prefill_devices`` 1, the ledger's "kv" hops and
    bytes those of one process;
  * paged KV with the radix prefix cache on 2 + 2 ranks (inline prefill,
    the pool replicated on the attention ranks) and with the prefill
    rank: tokens equal to the contiguous ones and to JAX's paged engine,
    the prefix cache's hits JAX's;
  * one decode rank beside a prefill rank (2 ranks): the one-card
    runtime on the decode rank, its KV from the prefill rank;
  * ``launch.serve.run(transport="multi")`` on 4 ranks (each drawing from
    the seed what its role keeps) against ``run`` in one process;
  * an expert group that does not divide the experts (1 + 3 ranks) is
    refused on every rank, as JAX refuses it;
  * ``ServingRoles`` splits ranks as JAX's ``split_serving_devices`` and
    ``DisaggregatedInstance`` split devices.
"""
import pickle

import pytest
import torch

import _torch_disagg as td
from repro_torch.launch.mesh import ServingRoles

torch.set_num_threads(1)

SERVE = dict(arch="mixtral-8x22b", use_reduced=True, device="cpu",
             runtime="pingpong", microbatches=2, use_m2n=True, n_requests=5,
             max_new=4, max_batch=4, max_seq=64, prompt_len=8, prefill_devices=1,
             verbose=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    pj = td.jax_params()
    base = dict(td.ENGINE, kind="engine", prompts=td.prompts(5), max_new=4)
    paged = dict(td.ENGINE, kind="engine", prompts=td.shared_prompts(5), max_new=4,
                 m2n=True)
    jax_cases = [dict(base, name="mono", mode="mono")]
    jax_cases += [dict(base, name=f"worker-{t}", mode="worker", attn=1, expert=2,
                       prefill=1, m2n=True, transfer=t) for t in ("sync", "async")]
    jax_cases += [dict(paged, name=f"paged-{lay}", mode="pingpong", attn=2, expert=2,
                       layout=lay) for lay in ("contiguous", "paged")]
    jax_cases += [dict(name="refuse", kind="refuse", attn=1, expert=3)]
    ranked = [dict(base, name=f"worker-{t}", prefill=1, m2n=True, transfer=t,
                   params=pj) for t in ("sync", "async")]
    ranked += [dict(paged, name=f"paged-{lay}", layout=lay, params=pj)
               for lay in ("contiguous", "paged")]
    ranked += [dict(paged, name="paged-worker", layout="paged", prefill=1, params=pj),
               dict(name="refuse", kind="refuse", attn_ranks=[0],
                    expert_ranks=[1, 2, 3], params=pj),
               dict(name="serve", kind="serve", prefill=1,
                    run=dict(SERVE, transport="multi"))]
    one_decode = [dict(base, name="one-decode", prefill=1, m2n=True, params=pj)]
    want, got = td.run(tmp_path_factory.mktemp("disagg_serving"), jax_cases,
                       [(4, ranked), (2, one_decode)])
    one = {"worker": td.one_process(pj, dict(base, prefill=1, m2n=True)),
           "paged-worker": td.one_process(pj, dict(paged, layout="paged",
                                                   prefill=1))}
    return want, got, one


def same_on_every_rank(results, key):
    first = pickle.dumps(results[0][key])
    return all(pickle.dumps(r[key]) == first for r in results)


@pytest.mark.parametrize("transfer", ["sync", "async"])
def test_prefill_rank_matches_jax(runs, transfer):
    want, got, one = runs
    ranks = got[f"worker-{transfer}"]
    assert [r["role"] for r in ranks] == ["attn", "expert", "expert", "prefill"]
    assert want[f"worker-{transfer}"]["tokens"] == want["mono"]["tokens"]
    for res in ranks:
        assert res["tokens"] == want["mono"]["tokens"] == one["worker"][0]
    assert same_on_every_rank(ranks, "stats")
    ph = ranks[0]["stats"]["phases"]
    assert ph["transfer_n"] == 5 and ph["prefill_devices"] == 1
    assert ph["transfer_mode"] == transfer and ph["prefills"] == 5
    jph = want[f"worker-{transfer}"]["stats"]["phases"]
    assert ph["transfer_n"] == jph["transfer_n"] and jph["prefill_devices"] == 1
    kv, kv1 = ranks[0]["stats"]["transport"]["kv"], one["worker"][1]["transport"]["kv"]
    assert (kv["hops"], kv["bytes"]) == (kv1["hops"], kv1["bytes"]) and kv["hops"] == 5
    by_rank = ranks[0]["stats"]["ranks"]
    assert by_rank[3]["transport"]["kv"]["hops"] == 5          # the prefill rank sends
    assert by_rank[0]["transport"]["kv"]["waits"] == 5         # the attention rank waits


@pytest.mark.parametrize("case", ["paged", "paged-worker"])
def test_paged_kv_on_ranks_matches_contiguous(runs, case):
    want, got, one = runs
    contig = got["paged-contiguous"][0]["tokens"]
    assert want["paged-paged"]["tokens"] == want["paged-contiguous"]["tokens"] == contig
    ranks = got[f"paged-{case}" if case == "paged" else case]
    for res in ranks:
        assert res["tokens"] == contig
    assert same_on_every_rank(ranks, "stats")
    st = ranks[0]["stats"]
    assert st["kv_layout"] == "paged" and st["kv_pages"]["high_water"] > 0
    if case == "paged":
        assert st["prefix_cache"] == want["paged-paged"]["stats"]["prefix_cache"]
        assert st["prefix_cache"]["hits"] > 0 and st["prefix_cache"]["hit_tokens"] > 0
    else:
        one_st = one["paged-worker"][1]
        assert one["paged-worker"][0] == contig
        assert st["prefix_cache"] == one_st["prefix_cache"]
        for k in ("hops", "bytes"):
            assert st["transport"]["kv"][k] == one_st["transport"]["kv"][k]


def test_serve_run_multi_on_ranks_matches_one_process(runs):
    from repro_torch.launch import serve
    _, got, _ = runs
    engines = []
    build = serve.build

    def keep(sc):
        cfg, eng = build(sc)
        engines.append(eng)
        return cfg, eng

    serve.build = keep
    try:
        st1 = serve.run(**dict(SERVE, transport="inproc"))
    finally:
        serve.build = build
    toks = {r.rid: list(r.generated) for r in engines[0].finished}
    ranks = got["serve"]
    assert [r["role"] for r in ranks] == ["attn", "expert", "expert", "prefill"]
    for res in ranks:
        assert res["tokens"] == toks
        st = res["stats"]
        for k in ("tokens", "decode_iters", "prefills", "finished"):
            assert st[k] == st1[k], k
        assert st["phases"]["prefill_devices"] == 1
        assert st["transport"]["kv"]["hops"] == st1["transport"]["kv"]["hops"] == 5
        assert [r["role"] for r in st["ranks"]] == ["attn", "expert", "expert",
                                                     "prefill"]
        # the expert ranks keep half the experts each, no embedding
        assert st["ranks"][1]["params_bytes"] < st["ranks"][0]["params_bytes"]


def test_one_decode_rank_beside_a_prefill_rank(runs):
    """2 ranks, 1 prefill: the decode rank runs both stages on its own,
    the one-card runtime, and takes its KV from the prefill rank."""
    want, got, _ = runs
    ranks = got["one-decode"]
    assert [r["role"] for r in ranks] == ["attn+expert", "prefill"]
    for res in ranks:
        assert res["tokens"] == want["mono"]["tokens"]
    ph = ranks[0]["stats"]["phases"]
    assert ph["transfer_n"] == 5 and ph["prefill_devices"] == 1
    assert ranks[0]["stats"]["ranks"][1]["transport"]["kv"]["hops"] == 5


def test_expert_group_that_does_not_divide_is_refused_on_every_rank(runs):
    want, got, _ = runs
    assert want["refuse"]["error"] is not None        # JAX refuses it too
    for res in got["refuse"]:
        assert "expert group of 3 ranks does not divide the 4 experts" in res["error"]


@pytest.mark.parametrize("world,prefill", [(1, 0), (2, 0), (3, 0), (4, 0), (4, 1),
                                           (8, 2), (2, 1), (3, 3)])
def test_roles_follow_the_jax_split(world, prefill):
    """The JAX launcher's split of devices, applied to rank numbers."""
    pytest.importorskip("jax")
    from repro.launch.mesh import split_serving_devices
    pre, dec = split_serving_devices(prefill, list(range(world)))
    half = max(1, len(dec) // 2)
    roles = ServingRoles(world, prefill)
    assert roles.prefill == tuple(pre) and roles.decode == tuple(dec)
    assert roles.attn == tuple(dec[:half])
    assert roles.expert == tuple(dec[half:] or dec[:1])
    assert roles.separate_prefill == bool(pre and not set(pre) & set(dec))
    one = len(dec) == 1
    assert roles.role(dec[0]) == ("attn+expert" if one else "attn")
    if pre and roles.separate_prefill:
        assert roles.role(pre[0]) == "prefill"


def test_pinned_groups():
    roles = ServingRoles(4, 0, attn_ranks=[0], expert_ranks=[1, 2, 3])
    assert (roles.attn, roles.expert, roles.decode) == ((0,), (1, 2, 3), (0, 1, 2, 3))
    with pytest.raises(ValueError, match="overlap"):
        ServingRoles(4, 0, attn_ranks=[0, 1], expert_ranks=[1, 2])
