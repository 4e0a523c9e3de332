"""The port's live expert placement, transport ledger and rebalancing
engine against the JAX package, on the CPU at reduced sizes.

  * ``core.load_balance`` is the port's own copy: ``balance_experts``
    and ``placement_tables`` must give identical arrays;
  * the runtime cases of the JAX package's ``TestRuntimePlacement``
    (``tests/test_expert_placement.py``), over the static and the m2n
    dispatch and 1 or 4 expert nodes: decode logits against the JAX
    monolithic ``decode_step`` at rtol = atol = 2e-4 (that test's
    tolerance) before and after a replicated placement is applied,
    routing counts exact;
  * the transport ledger and the RDMA cost model: equal to JAX's for the
    same hops (bytes and hop counts exact, simulated seconds to 1e-12);
  * the engine on reduced mixtral under a zipf(1.2) router bias,
    rebalancing every 2 decode iterations over 4 expert nodes: tokens,
    expert loads and replicated experts identical to the JAX engine on
    4 attention + 4 expert (forced host) devices, imbalance within 1e-9.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.config import get_config, reduced
from repro_torch.core import load_balance as lb
from repro_torch.core import transport as ttr
from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
from repro_torch.launch.serve import inject_router_bias, zipf_router_bias
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine, Request

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLACE_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import config as jconfig
    from repro.core import load_balance as jlb
    from repro.core import transport as jtr
    from repro.launch import serve as jserve
    from repro.models import transformer as jtf
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig, lb=jlb,
                                 tr=jtr, serve=jserve, tf=jtf)


# ------------------------------------------------------------ balancer
LOADS = [[50.0, 10.0, 5.0, 5.0], [1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0],
         [100.0] + [4.0] * 7, [30.0, 22.0, 17.0, 9.0, 3.0, 1.0],
         list(np.random.RandomState(0).zipf(1.5, 16).astype(float))]


@pytest.mark.parametrize("loads", LOADS, ids=range(len(LOADS)))
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("replicate", [True, False])
def test_balancer_and_tables_match_jax(jx, loads, n, replicate):
    want = jx.lb.balance_experts(loads, n, allow_replication=replicate)
    got = lb.balance_experts(loads, n, allow_replication=replicate)
    np.testing.assert_array_equal(got.fractions, want.fractions)
    np.testing.assert_array_equal(got.node_cost, want.node_cost)
    assert (got.max_cost, got.ideal) == (want.max_cost, want.ideal)
    e_loc = -(-len(loads) // n)
    S = min(len(loads), max(e_loc, round(e_loc * 2.0)))
    tw, tg = jx.lb.placement_tables(want, S), lb.placement_tables(got, S)
    for f in ("slot_experts", "rep_node", "rep_slot", "rep_cum", "fractions"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(tw, f))
    ev_w = jx.lb.evaluate_placement(tw.fractions, loads)
    ev_g = lb.evaluate_placement(tg.fractions, loads)
    assert ev_g.imbalance == ev_w.imbalance
    np.testing.assert_array_equal(
        lb.static_placement(len(loads), n).fractions,
        jx.lb.static_placement(len(loads), n).fractions)


@pytest.mark.parametrize("tok", [0, 1, 12345, 10939235, 10939236, 41745049,
                                 2 ** 31 - 1])
def test_token_hash_matches_jax_and_can_round_to_one(jx, tok):
    """The replica hash of the port (plain version; the CUDA kernel
    repeats it in uint32) is bit-identical to the JAX package's, also at
    10939236 and 41745049, the two smallest token indices below 2**26
    whose hash rounds to u = 1.0 in f32 (the kernel then clamps the
    replica to the last one)."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    want = np.asarray(jmoe._token_hash01(jx.jnp.asarray([tok], jx.jnp.int32)))
    got = tmoe.token_hash01(torch.tensor([tok])).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 1.0) == (tok in (10939236, 41745049))


# ------------------------------------------------------------ runtime
@pytest.fixture(scope="module")
def decode_ref(jx):
    """Reduced mixtral in both packages, a prefilled cache and the JAX
    monolithic decode_step's logits on it."""
    jcfg = jx.config.reduced(jx.config.get_config("mixtral-8x22b"))
    cfg = reduced(get_config("mixtral-8x22b"))
    pj = jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))
    B, T = 4, 8
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (B, T)).astype(np.int32)
    last, cache = jx.tf.prefill(pj, jcfg, jx.jnp.asarray(toks), max_seq=16)
    nxt = np.asarray(jx.jnp.argmax(last, -1)).astype(np.int32)
    pos = np.full((B,), T, np.int32)
    want, _ = jx.tf.decode_step(pj, jcfg, jx.jnp.asarray(nxt), cache,
                                jx.jnp.asarray(pos))
    cache_np = jx.jax.tree.map(np.asarray, cache)
    return types.SimpleNamespace(
        cfg=cfg, params=params_from_jax(jx.jax.tree.map(np.asarray, pj), cfg,
                                        device="cpu"),
        cache=lambda: cache_from_jax(cache_np, cfg, device="cpu"),
        nxt=torch.from_numpy(nxt), pos=torch.from_numpy(pos),
        want=np.asarray(want, np.float32), B=B)


@pytest.mark.parametrize("use_m2n", [False, True])
@pytest.mark.parametrize("nodes", [1, 4])
def test_applied_placement_matches_jax_decode(decode_ref, use_m2n, nodes):
    r, cfg = decode_ref, decode_ref.cfg
    inst = DisaggregatedInstance(cfg, r.params,
                                 DisaggPlan(n_microbatches=2, use_m2n=use_m2n),
                                 expert_nodes=nodes)
    got, _ = inst.decode_microbatched(r.nxt, r.cache(), r.pos)
    np.testing.assert_allclose(got.numpy(), r.want, **PLACE_TOL)
    counts = inst.take_expert_counts()
    assert counts.sum() == r.B * cfg.moe.top_k * cfg.n_layers
    # solve on a trace with a forced-hot expert 0 and decode again
    hot = counts + np.array([80.0] + [0.0] * (cfg.moe.n_experts - 1))
    assert inst.apply_placement(lb.balance_experts(hot, inst.n_expert_nodes))
    assert inst.layers_expert_placed[0]["we1"].shape[0] == \
        nodes * inst.placement_slots
    if nodes > 1:
        assert (inst.placement_fractions > 1e-9).sum(1).max() > 1
    got2, _ = inst.decode_microbatched(r.nxt, r.cache(), r.pos)
    np.testing.assert_allclose(got2.numpy(), r.want, **PLACE_TOL)
    # the counts keep accumulating over the placed path too
    assert inst.take_expert_counts().sum() == \
        r.B * cfg.moe.top_k * cfg.n_layers


@pytest.mark.parametrize("use_m2n", [False, True])
@pytest.mark.parametrize("nodes", [1, 4])
def test_active_slot_mask_gates_counts(decode_ref, use_m2n, nodes):
    cfg = decode_ref.cfg
    B = 4
    cache = init_cache(cfg, B, 16, device="cpu")
    toks = torch.zeros(B, dtype=torch.int64)
    pos = torch.zeros(B, dtype=torch.int32)
    inst = DisaggregatedInstance(cfg, decode_ref.params,
                                 DisaggPlan(n_microbatches=2, use_m2n=use_m2n),
                                 expert_nodes=nodes)
    inst.set_active_slots([1.0, 0.0, 0.0, 1.0])
    inst.decode_microbatched(toks, cache, pos)
    assert inst.take_expert_counts().sum() == 2 * cfg.moe.top_k * cfg.n_layers
    inst.set_active_slots(None)         # every row counts again
    inst.decode_microbatched(toks, cache, pos)
    assert inst.take_expert_counts().sum() == B * cfg.moe.top_k * cfg.n_layers


@pytest.mark.parametrize("use_m2n", [False, True])
@pytest.mark.parametrize("nodes", [1, 4])
def test_steady_state_reapply_is_skipped(decode_ref, use_m2n, nodes):
    inst = DisaggregatedInstance(decode_ref.cfg, decode_ref.params,
                                 DisaggPlan(n_microbatches=2, use_m2n=use_m2n),
                                 expert_nodes=nodes)
    loads = [50.0, 10.0, 5.0, 5.0]
    assert inst.apply_placement(lb.balance_experts(loads, nodes)) is True
    placed = inst.layers_expert_placed[0]["we1"]
    # the same traffic gives the same tables: the regather is skipped
    assert inst.apply_placement(lb.balance_experts(loads, nodes)) is False
    if nodes > 1:
        # another layout is installed again, into the same tensors
        assert inst.apply_placement(lb.balance_experts(loads[::-1], nodes))
        assert inst.layers_expert_placed[0]["we1"] is placed
        assert inst.transport.stats()["weights"]["hops"] == 2
    # every slot holds its expert's weights (pad slots expert 0's), also
    # where only the changed slots were rewritten
    src = np.maximum(inst.tables.slot_experts.reshape(-1), 0)
    for raw, pl in zip(inst.layers_expert, inst.layers_expert_placed):
        for k in ("we1", "we3", "we2"):
            assert torch.equal(pl[k], raw[k][torch.from_numpy(src).long()])


@pytest.mark.parametrize("use_m2n", [False, True])
@pytest.mark.parametrize("nodes", [1, 4])
def test_placement_needs_moe(decode_ref, use_m2n, nodes):
    cfg = dataclasses.replace(decode_ref.cfg, moe=None, d_ff=384)
    inst = DisaggregatedInstance(cfg, init_params(cfg, 0, device="cpu"),
                                 DisaggPlan(n_microbatches=1, use_m2n=use_m2n),
                                 expert_nodes=nodes)
    with pytest.raises(ValueError, match="MoE"):
        inst.apply_placement(lb.balance_experts([1.0], nodes))


def test_placement_needs_drop_free_capacity(decode_ref):
    inst = DisaggregatedInstance(decode_ref.cfg, decode_ref.params,
                                 DisaggPlan(n_microbatches=1,
                                            capacity_mode="train"),
                                 expert_nodes=2)
    with pytest.raises(ValueError, match="capacity_mode"):
        inst.apply_placement(lb.balance_experts([4.0, 1.0, 1.0, 1.0], 2))


# ------------------------------------------------------------ transport
def _hops(jx, jt, pt):
    """The same hops on a JAX and a port transport."""
    rng = np.random.RandomState(0)
    for shape, dt, fanout in (((4, 256), np.float32, 1), ((8, 4, 64), np.float32, 4),
                              ((3, 5), np.int32, 2)):
        a = rng.randn(*shape).astype(dt)
        jt.send_tokens(jx.jnp.asarray(a), None, fanout=fanout)
        pt.send_tokens(torch.from_numpy(a), fanout=fanout)
    w = [{"we1": rng.randn(8, 16, 32).astype(np.float32)}] * 2
    jt.regather_weights([{k: jx.jnp.asarray(v) for k, v in d.items()} for d in w],
                        None)
    pt.regather_weights([{k: torch.from_numpy(v) for k, v in d.items()} for d in w])
    for n, fanout in ((98304, 4), (7, 1), (123457, 3)):
        jt.record_collective(n, fanout=fanout)
        pt.record_collective(n, fanout=fanout)


@pytest.mark.parametrize("backend", ["inproc", "simrdma", "simrdma-nccl"])
def test_transport_ledger_matches_jax(jx, backend):
    if backend == "inproc":
        jt, pt = jx.tr.InProcessTransport(), ttr.InProcessTransport()
    else:
        model = "nccl_grouped_p2p" if backend == "simrdma-nccl" else "m2n_rdma"
        jt = jx.tr.SimRdmaTransport(getattr(jx.tr.RdmaCostModel, model)(),
                                    default_fanout=3)
        pt = ttr.SimRdmaTransport(getattr(ttr.RdmaCostModel, model)(),
                                  default_fanout=3)
    _hops(jx, jt, pt)
    want, got = jt.stats(), pt.stats()
    assert got["backend"] == want["backend"]
    assert set(got) == set(want)
    for kind in ttr.HOP_KINDS:
        if kind in want:
            assert got[kind]["hops"] == want[kind]["hops"]
            assert got[kind]["bytes"] == want[kind]["bytes"]
            assert got[kind]["sim_s"] == pytest.approx(want[kind]["sim_s"],
                                                       rel=0, abs=1e-12)
    pt.reset_stats()
    assert pt.stats() == {"backend": pt.name}


@pytest.mark.parametrize("model", ["nccl_grouped_p2p", "m2n_rdma"])
def test_rdma_cost_model_matches_jax(jx, model):
    jm = getattr(jx.tr.RdmaCostModel, model)()
    tm = getattr(ttr.RdmaCostModel, model)()
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for size in (0, 4096, 1 << 20, 98304):
        for n in (1, 2, 8, 9, 64):
            assert tm.one_to_n(size, n) == jm.one_to_n(size, n)
            assert tm.p99_one_to_n(size, n) == jm.p99_one_to_n(size, n)


def test_make_transport_names():
    assert ttr.make_transport("inproc").name == "inproc"
    assert ttr.make_transport("simrdma").name == "simrdma"
    with pytest.raises(NotImplementedError, match="multi-process"):
        ttr.make_transport("multi")
    with pytest.raises(ValueError):
        ttr.make_transport("tcp")


# ------------------------------------------------------------ engine
@pytest.mark.parametrize("case", ["monolithic", "capacity", "dense",
                                  "no-runtime", "transport", "nodes"])
def test_engine_constructor_refusals(decode_ref, case):
    cfg, params = decode_ref.cfg, decode_ref.params
    sc = dict(max_batch=4, max_seq=32, device="cpu", verbose=False)
    if case == "transport":
        with pytest.raises(ValueError, match="transport"):
            ServingConfig(transport="tcp", **sc)
        return
    if case == "nodes":
        with pytest.raises(ValueError, match="expert_nodes"):
            ServingConfig(expert_nodes=0, **sc)
        with pytest.raises(ValueError, match="expert_nodes"):
            DisaggregatedInstance(cfg, params, expert_nodes=0)
        return
    if case == "no-runtime":
        with pytest.raises(ValueError, match="runtime"):
            Engine(cfg, params, config=ServingConfig(runtime="pingpong", **sc))
        return
    plan = DisaggPlan(n_microbatches=2)
    if case == "monolithic":
        conf = ServingConfig(expert_rebalance_every=2, **sc)
        inst = DisaggregatedInstance(cfg, params, plan)
        match = "pingpong"
    elif case == "capacity":
        conf = ServingConfig(runtime="pingpong", expert_rebalance_every=2, **sc)
        inst = DisaggregatedInstance(
            cfg, params, DisaggPlan(n_microbatches=2, capacity_mode="train"))
        match = "capacity_mode"
    else:
        cfg = dataclasses.replace(cfg, moe=None, d_ff=384)
        params = init_params(cfg, 0, device="cpu")
        conf = ServingConfig(runtime="pingpong", expert_rebalance_every=2, **sc)
        inst = DisaggregatedInstance(cfg, params, plan)
        match = "MoE"
    with pytest.raises(ValueError, match=match):
        Engine(cfg, params, config=conf, runtime=inst)


def test_monolithic_engine_reports_no_imbalance(decode_ref):
    eng = Engine(decode_ref.cfg, decode_ref.params,
                 config=ServingConfig(max_batch=2, max_seq=32, device="cpu",
                                      verbose=False))
    st = eng.stats()
    assert "imbalance" not in st and st["transport"] == {"backend": "inproc"}


JAX_ENGINES = """
import json
import jax, numpy as np
assert jax.device_count() == 8, jax.device_count()
from repro.config import get_config, reduced
from repro.core.disagg import DisaggPlan, DisaggregatedInstance
from repro.launch.serve import _inject_router_bias, zipf_router_bias
from repro.models import init_params
from repro.serving.config import ServingConfig
from repro.serving.engine import Engine, Request
cfg = reduced(get_config("mixtral-8x22b"))
params = init_params(cfg, jax.random.PRNGKey(0))
params = _inject_router_bias(params, cfg, zipf_router_bias(cfg.moe.n_experts, 1.2))
rng = np.random.RandomState(0)
prompts = [rng.randint(2, cfg.vocab, size=rng.randint(2, 8)).tolist()
           for _ in range(6)]
devs = jax.devices()
out = {}
for name, m2n, every in RUNS:
    inst = DisaggregatedInstance(cfg, params, attn_devices=devs[:4],
                                 expert_devices=devs[4:],
                                 plan=DisaggPlan(n_microbatches=2, use_m2n=m2n))
    eng = Engine(cfg, params, runtime=inst, config=ServingConfig(
        max_batch=4, max_seq=64, runtime="pingpong",
        expert_rebalance_every=every, verbose=False))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    toks = {r.rid: r.generated for r in eng.run_until_done()}
    st = eng.stats()
    out[name] = dict(prompts=prompts, tokens={str(k): v for k, v in toks.items()},
                     **{k: st[k] for k in ("expert_loads", "replicated_experts",
                                           "imbalance", "rebalances",
                                           "placement_updates")})
print("JSON" + json.dumps(out))
"""
RUNS = [("static", False, 0), ("rebalanced", False, 2), ("m2n+rebalanced", True, 2)]


@pytest.fixture(scope="module")
def jax_engines():
    pytest.importorskip("jax")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c",
                        f"RUNS = {RUNS!r}\n" + JAX_ENGINES], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.mark.parametrize("name,use_m2n,every", RUNS)
def test_engine_rebalance_matches_jax_engine(jx, jax_engines, name, use_m2n,
                                             every):
    """Static, rebalanced and m2n + rebalanced serving at 4 expert nodes
    under zipf(1.2) routing: the JAX engine's tokens, loads, replicated
    experts and imbalance, and the rebalanced runs replicate a hot expert
    and lower the imbalance below the static run's."""
    want = jax_engines[name]
    jcfg = jx.config.reduced(jx.config.get_config("mixtral-8x22b"))
    cfg = reduced(get_config("mixtral-8x22b"))
    bias = zipf_router_bias(cfg.moe.n_experts, 1.2)
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(jx.serve.zipf_router_bias(cfg.moe.n_experts, 1.2)))
    pj = jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))
    params = inject_router_bias(
        params_from_jax(jx.jax.tree.map(np.asarray, pj), cfg, device="cpu"),
        cfg, bias)
    inst = DisaggregatedInstance(cfg, params,
                                 DisaggPlan(n_microbatches=2, use_m2n=use_m2n),
                                 expert_nodes=4)
    eng = Engine(cfg, params, runtime=inst, config=ServingConfig(
        max_batch=4, max_seq=64, runtime="pingpong", microbatches=2,
        expert_rebalance_every=every, device="cpu", verbose=False))
    for i, p in enumerate(want["prompts"]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    eng.run_until_done()
    toks = {str(r.rid): r.generated for r in eng.finished}
    st = eng.stats()
    assert toks == want["tokens"]
    assert st["expert_loads"] == want["expert_loads"]
    assert st["replicated_experts"] == want["replicated_experts"]
    assert abs(st["imbalance"] - want["imbalance"]) <= 1e-9
    assert (st["rebalances"], st["placement_updates"]) == \
        (want["rebalances"], want["placement_updates"])
    if every:
        assert toks == jax_engines["static"]["tokens"]
        assert st["rebalances"] > 0 and st["replicated_experts"] >= 1
        assert st["imbalance"] < jax_engines["static"]["imbalance"]
