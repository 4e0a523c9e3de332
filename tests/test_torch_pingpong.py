"""The port's micro-batch choice (paper eq. 3) and its ``disagg`` runtime
against the JAX package, on the CPU.

  * every function of ``core.pingpong`` equals the JAX one over a grid
    of (t_a, t_e, t_c, m, L), simulator events included;
  * ``stage_report()`` carries every key of the JAX report (and the
    port's hop count, stream stalls and CUDA-graph counters), with the same counts as JAX
    ``measure_stage_times`` on reduced mixtral-8x22b (``attn_n ==
    expert_n == m2n_n == n2m_n == m * L``);
  * T_c is what the transport priced the hops at: 0 under ``inproc``,
    the RDMA cost model's latency under ``simrdma``;
  * ``auto_microbatches`` obeys eq. 3 on one measurement (the JAX
    package's ``tests/test_pingpong_runtime.py`` relation);
  * ``--runtime disagg`` serving gives the JAX disagg engine's tokens and
    expert loads, and the launcher's ``--microbatches auto`` picks m
    before the engine is built.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config, reduced
from repro_torch.core import pingpong
from repro_torch.core.disagg import STAGES, DisaggPlan, DisaggregatedInstance
from repro_torch.core.transport import RdmaCostModel, make_transport
from repro_torch.launch.serve import run
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine, Request

torch.set_num_threads(1)

# (t_a, t_e, t_c): balanced and not, no / slow / fast hops, and the
# H100 stage times' scale (ms-sized stages, a 22.7 us priced hop)
TIMES = [(1.0, 0.9, 0.3), (1.0, 1.0, 0.0), (0.5, 2.0, 0.7),
         (2.0, 0.5, 3.0), (1.47e-3, 1.69e-3, 2.27e-5), (1e-3, 1e-3, 1e-3)]
GRID_M = (1, 2, 3, 4, 7)
GRID_L = (1, 3, 8)
WORKLOAD = dict(n_requests=6, max_new=4, max_batch=4, max_seq=64, prompt_len=8,
                microbatches=2)


@pytest.fixture(scope="module")
def jpp():
    pytest.importorskip("jax")
    from repro.core import pingpong as jpingpong
    return jpingpong


@pytest.mark.parametrize("t_a,t_e,t_c", TIMES)
def test_pingpong_functions_match_jax(jpp, t_a, t_e, t_c):
    t_f = max(t_a, t_e)
    assert pingpong.min_microbatches(t_c, t_f) == jpp.min_microbatches(t_c, t_f)
    for max_m in (None, 1, 2, 3, 8):
        assert (pingpong.choose_microbatches(t_a, t_e, t_c, max_m=max_m)
                == jpp.choose_microbatches(t_a, t_e, t_c, max_m=max_m))
    for m in GRID_M:
        for tol in (0.1, 0.25):
            assert (pingpong.conditions_met(t_a, t_e, t_c, m, tol)
                    == jpp.conditions_met(t_a, t_e, t_c, m, tol))
        for L in GRID_L:
            assert (pingpong.iteration_latency(t_a, t_e, t_c, m, L)
                    == jpp.iteration_latency(t_a, t_e, t_c, m, L))
            assert (pingpong.microbatch_latency_bounds(t_a, t_e, t_c, m, L)
                    == jpp.microbatch_latency_bounds(t_a, t_e, t_c, m, L))
            got = pingpong.simulate_pingpong(t_a, t_e, t_c, m, L,
                                             record_events=True)
            want = jpp.simulate_pingpong(t_a, t_e, t_c, m, L, record_events=True)
            assert vars(got) == vars(want)
            assert pingpong.schedule_from_events(got.events) == \
                jpp.schedule_from_events(want.events) == \
                pingpong.build_schedule(m, L) == jpp.build_schedule(m, L)
            assert pingpong.throughput(8 * m, got.total_time) == \
                jpp.throughput(8 * m, want.total_time)
            n = m * L
            assert pingpong.even_partition(n, m) == jpp.even_partition(n, m)


@pytest.fixture(scope="module")
def mixtral():
    """Reduced mixtral-8x22b in both packages, on the same weights."""
    jax = pytest.importorskip("jax")
    from repro.config import get_config as jget, reduced as jreduced
    from repro.models import init_params as jinit
    jcfg = jreduced(jget("mixtral-8x22b"))
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("mixtral-8x22b"))
    return types.SimpleNamespace(
        jax=jax, jcfg=jcfg, jparams=jparams, cfg=cfg,
        params=params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu"))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_stage_report_counts_match_jax(mixtral, m):
    from repro.core.disagg import DisaggPlan as JPlan
    from repro.core.disagg import DisaggregatedInstance as JInst
    want = JInst(mixtral.jcfg, mixtral.jparams,
                 plan=JPlan(n_microbatches=m)).measure_stage_times(4)
    inst = DisaggregatedInstance(mixtral.cfg, mixtral.params, DisaggPlan(m))
    got = inst.measure_stage_times(4)
    assert set(got) >= set(want)
    assert set(got) - set(want) == {"hops", "m2n_wait_s", "n2m_wait_s",
                                    "graphed_n", "captures"}
    L = mixtral.cfg.n_layers
    for s in STAGES:
        assert got[f"{s}_n"] == want[f"{s}_n"] == m * L
    assert got["hops"] == 2 * m * L
    assert got["t_a"] > 0 and got["t_e"] > 0 and got["t_c"] == 0.0
    # a hop on the CPU is no stream wait: nothing stalls
    assert got["m2n_wait_s"] == got["n2m_wait_s"] == 0.0
    # profiling leaves the stage accumulators and the traffic trace empty
    assert inst.stage_report()["attn_n"] == 0
    assert inst.peek_expert_counts().sum() == 0


@pytest.mark.parametrize("use_m2n,nodes", [(False, 1), (True, 1), (True, 4)])
@pytest.mark.parametrize("backend", ["inproc", "simrdma"])
def test_t_c_is_the_priced_hop(mixtral, backend, use_m2n, nodes):
    """T_c is the mean of what the transport priced the M2N / N2M hops
    at, the ledger's "tokens" hops: 0 under inproc, the RDMA cost
    model's one-to-N latency of the hop's payload under simrdma."""
    tr = make_transport(backend)
    inst = DisaggregatedInstance(mixtral.cfg, mixtral.params,
                                 DisaggPlan(2, use_m2n=use_m2n),
                                 expert_nodes=nodes, transport=tr)
    rep = inst.measure_stage_times(4)
    hops = tr.stats()["tokens"]
    assert hops["hops"] == 2 * rep["hops"]          # warm-up + profiled
    assert rep["t_c"] == pytest.approx(hops["sim_s"] / hops["hops"], rel=1e-12)
    assert rep["m2n_s"] + rep["n2m_s"] == pytest.approx(hops["sim_s"] / 2,
                                                       rel=1e-12)
    if backend == "inproc":
        assert rep["t_c"] == 0.0
        return
    d, itemsize = mixtral.cfg.d_model, 4
    if use_m2n:
        # M2N: the (T, d) activations to every node; N2M: (T, d) back
        m2n = RdmaCostModel.m2n_rdma().one_to_n(2 * d * itemsize, nodes)
        n2m = RdmaCostModel.m2n_rdma().one_to_n(2 * d * itemsize, 1)
        assert rep["t_c"] == pytest.approx((m2n + n2m) / 2, rel=1e-12)
    else:
        # both ways the (E, C, d) capacity buffers, C = T = 2 rows
        E = mixtral.cfg.moe.n_experts
        want = RdmaCostModel.m2n_rdma().one_to_n(E * 2 * d * itemsize, 1)
        assert rep["t_c"] == pytest.approx(want, rel=1e-12)
    m = inst.auto_microbatches(4, max_m=4)
    assert m == pingpong.choose_microbatches(rep["t_a"], rep["t_e"],
                                             rep["t_c"], max_m=4) == 3


def test_auto_microbatches_feasible(mixtral):
    inst = DisaggregatedInstance(mixtral.cfg, mixtral.params, DisaggPlan(2))
    m = inst.auto_microbatches(4, max_m=4)
    assert 1 <= m <= 4
    # the relation on one measurement (two wall-clock profiles may round
    # to different m)
    rep = inst.measure_stage_times(4)
    unclamped = pingpong.min_microbatches(rep["t_c"], max(rep["t_a"], rep["t_e"]))
    got = pingpong.choose_microbatches(rep["t_a"], rep["t_e"], rep["t_c"],
                                       max_m=4)
    assert got == min(4, max(1, unclamped))
    # under inproc T_c = 0, so eq. 3 gives m = 2 exactly
    assert m == got == 2


def _prompts(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=WORKLOAD["prompt_len"]).tolist()
            for _ in range(WORKLOAD["n_requests"])]


def _serve(engine, prompts, request_cls):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=list(p),
                                  max_new_tokens=WORKLOAD["max_new"]))
    engine.run_until_done()
    return {r.rid: list(r.generated) for r in engine.finished}


def test_disagg_engine_matches_jax(mixtral):
    from repro.core.disagg import DisaggPlan as JPlan
    from repro.core.disagg import DisaggregatedInstance as JInst
    from repro.serving.config import ServingConfig as JConfig
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import Request as JRequest
    kw = dict(max_batch=WORKLOAD["max_batch"], max_seq=WORKLOAD["max_seq"],
              runtime="disagg", microbatches=WORKLOAD["microbatches"],
              verbose=False)
    prompts = _prompts(mixtral.cfg.vocab)
    jinst = JInst(mixtral.jcfg, mixtral.jparams,
                  plan=JPlan(n_microbatches=WORKLOAD["microbatches"]))
    jeng = JEngine(mixtral.jcfg, mixtral.jparams, config=JConfig(**kw),
                   runtime=jinst, decode_fn=jinst.decode_step)
    want = _serve(jeng, prompts, JRequest)
    inst = DisaggregatedInstance(mixtral.cfg, mixtral.params,
                                 DisaggPlan(WORKLOAD["microbatches"]))
    eng = Engine(mixtral.cfg, mixtral.params,
                 config=ServingConfig(device="cpu", **kw), runtime=inst)
    got = _serve(eng, prompts, Request)
    assert len(got) == WORKLOAD["n_requests"]
    assert got == want
    st, jst = eng.stats(), jeng.stats()
    assert st["mode"] == jst["mode"] == "monolithic"
    assert st["expert_loads"] == jst["expert_loads"]
    assert st["imbalance"] == jst["imbalance"]
    # one decode step of the whole batch, in m micro-batches
    L = mixtral.cfg.n_layers
    assert inst.last_trace == pingpong.build_schedule(WORKLOAD["microbatches"], L)


def test_disagg_engine_rebalances(mixtral):
    """Live placement runs in the disagg mode too (one expert node): the
    port's tokens and expert-balance counters equal the JAX disagg
    engine's with the same rebalancing, and its tokens the port's
    monolithic engine's."""
    from repro.core.disagg import DisaggPlan as JPlan
    from repro.core.disagg import DisaggregatedInstance as JInst
    from repro.serving.config import ServingConfig as JConfig
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import Request as JRequest
    kw = dict(max_batch=4, max_seq=64, runtime="disagg", microbatches=2,
              verbose=False, expert_rebalance_every=2)
    prompts = _prompts(mixtral.cfg.vocab, seed=1)[:4]
    jinst = JInst(mixtral.jcfg, mixtral.jparams, plan=JPlan(n_microbatches=2))
    jeng = JEngine(mixtral.jcfg, mixtral.jparams, config=JConfig(**kw),
                   runtime=jinst, decode_fn=jinst.decode_step)
    want = _serve(jeng, prompts, JRequest)
    sc = ServingConfig(device="cpu", **kw)
    inst = DisaggregatedInstance(mixtral.cfg, mixtral.params, DisaggPlan(2))
    eng = Engine(mixtral.cfg, mixtral.params, config=sc, runtime=inst)
    got = _serve(eng, prompts, Request)
    ref = Engine(mixtral.cfg, mixtral.params,
                 config=ServingConfig(max_batch=4, max_seq=64, device="cpu",
                                      verbose=False))
    assert got == want == _serve(ref, prompts, Request)
    st, jst = eng.stats(), jeng.stats()
    assert st["rebalances"] > 0
    for k in ("expert_loads", "rebalances", "placement_updates",
              "replicated_experts", "decode_iters"):
        assert st[k] == jst[k], k
    with pytest.raises(ValueError, match="needs a DisaggregatedInstance"):
        Engine(mixtral.cfg, mixtral.params, config=sc)


def test_launcher_picks_m_before_the_engine(capsys):
    """``--microbatches auto`` with the prefill worker: the launcher
    profiles at m = 2, prints the m it chose, and serves with it."""
    st = run(arch="mixtral-8x22b", use_reduced=True, device="cpu",
             runtime="pingpong", microbatches="auto", prefill_devices=1,
             transfer="async", n_requests=4, max_new=3, prompt_len=8)
    out = capsys.readouterr().out
    assert "auto-selected m=2 micro-batches" in out
    assert "overlapping, single-device fallback" in out
    assert st["n_microbatches"] == 2 and st["disagg_prefill"]
    assert st["finished"] == 4 and st["phases"]["transfer_mode"] == "async"
    assert st["transport"]["kv"]["hops"] == 4
    with pytest.raises(ValueError):
        ServingConfig(microbatches="many")
