"""The port's serving slice against the JAX package, on the CPU.

The JAX ``Engine`` in ``pingpong`` mode with the Pallas kernels
(``DisaggPlan(use_kernels=True)``, interpret mode) serves serve_bench's
workload shape (6 requests, 4 new tokens, max_batch 4, max_seq 64,
prompts of 8 tokens, m = 2) on reduced mixtral-8x22b; the port's
``Engine`` in ``pingpong`` and in ``monolithic`` mode serves the same
requests with the same weights (through ``repro_torch.bridge``).  Greedy
tokens must be identical for every request, and the port's issue trace
must equal ``build_schedule(m, L)``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config, reduced
from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
from repro_torch.core.pingpong import build_schedule, even_partition
from repro_torch.models.transformer import init_params
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kvcache import MicrobatchSlotAllocator
from repro_torch.serving.sampler import SamplingParams, sample_rows

torch.set_num_threads(1)

WORKLOAD = dict(n_requests=6, max_new=4, max_batch=4, max_seq=64, prompt_len=8,
                microbatches=2)


def _prompts(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=WORKLOAD["prompt_len"]).tolist()
            for _ in range(WORKLOAD["n_requests"])]


def _serve(engine, prompts):
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=list(p),
                              max_new_tokens=WORKLOAD["max_new"]))
    engine.run_until_done()
    return {r.rid: list(r.generated) for r in engine.finished}


@pytest.fixture(scope="module")
def jax_run():
    """Tokens of the JAX ping-pong engine on the Pallas kernels."""
    jax = pytest.importorskip("jax")
    from repro.config import get_config as jget, reduced as jreduced
    from repro.core.disagg import DisaggPlan as JPlan
    from repro.core.disagg import DisaggregatedInstance as JInst
    from repro.core.pingpong import build_schedule as jschedule
    from repro.models import init_params as jinit
    from repro.serving.config import ServingConfig as JConfig
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import Request as JRequest

    cfg = jreduced(jget("mixtral-8x22b"))
    params = jinit(cfg, jax.random.PRNGKey(0))
    inst = JInst(cfg, params, plan=JPlan(n_microbatches=WORKLOAD["microbatches"],
                                         use_kernels=True))
    eng = JEngine(cfg, params, runtime=inst, config=JConfig(
        max_batch=WORKLOAD["max_batch"], max_seq=WORKLOAD["max_seq"],
        runtime="pingpong", verbose=False))
    prompts = _prompts(cfg.vocab)
    for i, p in enumerate(prompts):
        eng.submit(JRequest(rid=i, prompt=list(p),
                            max_new_tokens=WORKLOAD["max_new"]))
    eng.run_until_done()
    tokens = {r.rid: list(r.generated) for r in eng.finished}
    return types.SimpleNamespace(
        params=jax.tree.map(np.asarray, params), prompts=prompts, tokens=tokens,
        trace=list(inst.last_trace), schedule=jschedule)


@pytest.fixture(scope="module")
def port_cfg():
    return reduced(get_config("mixtral-8x22b"))


def _port_engine(cfg, params, runtime):
    sc = ServingConfig(max_batch=WORKLOAD["max_batch"], max_seq=WORKLOAD["max_seq"],
                       runtime=runtime, microbatches=WORKLOAD["microbatches"],
                       device="cpu", verbose=False)
    inst = (DisaggregatedInstance(cfg, params, DisaggPlan(sc.microbatches))
            if runtime == "pingpong" else None)
    return Engine(cfg, params, config=sc, runtime=inst), inst


@pytest.mark.parametrize("runtime", ["pingpong", "monolithic"])
def test_port_engine_tokens_match_jax_pingpong(jax_run, port_cfg, runtime):
    params = params_from_jax(jax_run.params, port_cfg, device="cpu")
    eng, inst = _port_engine(port_cfg, params, runtime)
    got = _serve(eng, jax_run.prompts)
    assert len(got) == WORKLOAD["n_requests"]
    assert got == jax_run.tokens
    if inst is not None:
        L, m = port_cfg.n_layers, WORKLOAD["microbatches"]
        assert inst.last_trace == build_schedule(m, L)
        assert build_schedule(m, L) == jax_run.schedule(m, L)
        assert [tuple(t) for t in jax_run.trace] == inst.last_trace
        st = eng.stats()
        assert st["stages"]["attn_n"] == st["stages"]["expert_n"] > 0
        # every decode row was counted only while it served a request
        assert sum(st["expert_loads"]) == pytest.approx(
            port_cfg.moe.top_k * port_cfg.n_layers
            * (st["tokens"] - st["prefills"]))


@pytest.mark.parametrize("variant", ["moe", "dense"])
def test_pingpong_matches_monolithic_logits(port_cfg, variant):
    """One decode step: the ping-pong runtime (plain kernels on the CPU)
    gives the monolithic decode_step's logits, and writes the same cache
    rows in place.  The dense variant also covers post-norms, tied
    embeddings and the logit softcap."""
    import dataclasses
    from repro_torch.models.transformer import decode_step, init_cache, prefill
    if variant == "dense":
        port_cfg = dataclasses.replace(
            port_cfg, moe=None, d_ff=384, use_post_norm=True,
            tie_embeddings=True, logit_softcap=30.0, act="gelu")
    params = init_params(port_cfg, 1, device="cpu")
    B, T = 4, 5
    toks = torch.randint(0, port_cfg.vocab, (B, T),
                         generator=torch.Generator().manual_seed(0))
    _, rc = prefill(params, port_cfg, toks, max_seq=16)
    caches = [init_cache(port_cfg, B, 16, device="cpu") for _ in range(2)]
    for c in caches:
        for full, part in zip(c, rc):
            for k in full:
                full[k].copy_(part[k])
    nxt, pos = toks[:, -1], torch.full((B,), T, dtype=torch.int32)
    want, c0 = decode_step(params, port_cfg, nxt, caches[0], pos)
    inst = DisaggregatedInstance(port_cfg, params, DisaggPlan(n_microbatches=3))
    got, c1 = inst.decode_microbatched(nxt, caches[1], pos)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
    for a, b in zip(c0, c1):
        assert torch.equal(a["pos"], b["pos"])
        torch.testing.assert_close(a["k"], b["k"])
    assert inst.last_trace == build_schedule(len(even_partition(B, 3)),
                                             port_cfg.n_layers)


def test_pingpong_expert_phase_gets_the_dispatch_table(port_cfg, monkeypatch):
    """The runtime hands each micro-batch's dispatch table across the M2N
    hop with its payload and into the expert MLP, with the micro-batch's
    token count as the sentinel; the logits equal those of the same step
    with the table withheld (the expert MLP's full product)."""
    from repro_torch.core import disagg
    from repro_torch.models.transformer import init_cache, prefill
    params = init_params(port_cfg, 2, device="cpu")
    B, T = 4, 5
    toks = torch.randint(0, port_cfg.vocab, (B, T),
                         generator=torch.Generator().manual_seed(1))
    _, rc = prefill(params, port_cfg, toks, max_seq=16)
    nxt, pos = toks[:, -1], torch.full((B,), T, dtype=torch.int32)
    orig = disagg.kops.grouped_mlp
    calls, hops = [], []

    def step(keep_table):
        def mlp(xe, *w, idx=None, n_tokens=None, **kw):
            calls.append((xe, idx, n_tokens))
            if not keep_table:
                idx = n_tokens = None
            return orig(xe, *w, idx=idx, n_tokens=n_tokens, **kw)
        monkeypatch.setattr(disagg.kops, "grouped_mlp", mlp)
        cache = init_cache(port_cfg, B, 16, device="cpu")
        for full, part in zip(cache, rc):
            for k in full:
                full[k].copy_(part[k])
        inst = DisaggregatedInstance(port_cfg, params, DisaggPlan(n_microbatches=2))
        hop = inst._hop

        def logged_hop(stage, payload, *a, also=(), **kw):
            hops.append((stage, payload, also))
            return hop(stage, payload, *a, also=also, **kw)
        inst._hop = logged_hop
        return inst.decode_microbatched(nxt, cache, pos)[0]

    with_table = step(True)
    n = len(calls)
    assert n == 2 * port_cfg.n_layers
    m2n = [(p, a) for st, p, a in hops if st == "m2n"]
    assert len(m2n) == n
    E = port_cfg.moe.n_experts
    for (xe, idx, n_tok), (payload, also) in zip(calls, m2n):
        assert payload is xe and len(also) == 1 and also[0] is idx
        assert idx.dtype == torch.int32 and idx.shape == (E, xe.shape[1])
        assert n_tok == B // 2 and int(idx.max()) <= n_tok
    without = step(False)
    assert torch.equal(with_table, without)
    assert torch.equal(with_table.argmax(-1), without.argmax(-1))


def test_microbatch_slices_must_tile_the_batch(port_cfg):
    params = init_params(port_cfg, 0, device="cpu")
    inst = DisaggregatedInstance(port_cfg, params)
    from repro_torch.models.transformer import init_cache
    cache = init_cache(port_cfg, 4, 8, device="cpu")
    toks, pos = torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguously"):
        inst.decode_microbatched(toks, cache, pos, [slice(0, 2), slice(3, 4)])


def test_microbatch_allocator_keeps_groups():
    groups = even_partition(7, 3)
    assert [(s.start, s.stop) for s in groups] == [(0, 3), (3, 5), (5, 7)]
    a = MicrobatchSlotAllocator(7, groups)
    slots = [a.alloc(r) for r in range(7)]
    assert sorted(slots) == list(range(7)) and a.alloc(99) is None
    for r in (0, 3):
        g = a.group_of(a.used[r])
        s = a.release(r)
        assert a.group_of(s) == g
    with pytest.raises(ValueError):
        a.alloc(1)                                    # rid already holds a slot
    with pytest.raises(ValueError):
        MicrobatchSlotAllocator(6, [slice(0, 2), slice(3, 6)])


def test_retired_rows_are_reset(port_cfg):
    params = init_params(port_cfg, 0, device="cpu")
    eng, _ = _port_engine(port_cfg, params, "monolithic")
    _serve(eng, _prompts(port_cfg.vocab)[:2])
    rows = [r.slot for r in eng.finished]
    assert len(rows) == 2
    for entry in eng.cache:
        assert bool((entry["pos"][rows] == -1).all())


def test_sampling_does_not_depend_on_the_row():
    """Temperature sampling draws per request id: permuting the batch
    rows leaves every request's token unchanged."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(5, 50, generator=g)
    rids = np.array([7, 3, 11, 0, 5])
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.9)
    a = sample_rows(logits, 1234, rids, sp)
    perm = [3, 0, 4, 1, 2]
    b = sample_rows(logits[perm], 1234, rids[perm], sp)
    assert a[perm].tolist() == b.tolist()
    assert sample_rows(logits, 1, rids).tolist() == logits.argmax(-1).tolist()


def test_serving_config_validates():
    with pytest.raises(ValueError):
        ServingConfig(runtime="disaggregated")
    with pytest.raises(ValueError):
        ServingConfig(transfer="dma")
    with pytest.raises(ValueError):
        ServingConfig(dtype="float16")
    with pytest.raises(ValueError):
        ServingConfig(microbatches=0)
