"""The port's paged KV serving path against the JAX package's, on the CPU.

The JAX ``Engine`` with ``kv_layout="paged"`` (monolithic and ping-pong,
prefix cache on and off) serves a shared-system-prompt workload on
reduced mixtral-8x22b and dbrx; the port's ``Engine`` serves the same
requests with the same weights (``repro_torch.bridge``).  The workload
recycles KV rows (more requests than rows), grows every request into
new pages, and wraps the ring past ``max_seq`` so the prefix cache's
shared first page is forked on write.  Required: identical greedy tokens
(also against the port's contiguous engine), identical ``prefix_cache``
and ``kv_pages`` stats, the same pool afterwards (page ids, refcounts,
free list, and contents: positions exact, K/V at 5e-4), and
``suffix_prefill`` logits within 5e-4 of the JAX ones.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import cache_from_jax, pages_from_jax, params_from_jax
from repro_torch.config import get_config, reduced
from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.prefill import suffix_prefill

torch.set_num_threads(1)

# 20-token prompts opening with a 16-token (two-page) shared prefix;
# 20 + 14 positions wrap the 32-slot ring into the shared first page
WORKLOAD = dict(n_requests=6, max_new=14, max_batch=4, max_seq=32, page_size=8,
                prompt_len=20, shared_prefix_len=16, microbatches=2)
TOL = dict(rtol=5e-4, atol=5e-4)
ARCHS = ["mixtral-8x22b", "dbrx"]
RUNS = [("monolithic", True), ("monolithic", False), ("pingpong", True),
        ("pingpong", False)]


def _prompts(vocab, seed=0):
    rng = np.random.RandomState(seed)
    shared = rng.randint(2, vocab, size=WORKLOAD["shared_prefix_len"]).tolist()
    tail = WORKLOAD["prompt_len"] - WORKLOAD["shared_prefix_len"]
    return [shared + rng.randint(2, vocab, size=tail).tolist()
            for _ in range(WORKLOAD["n_requests"])]


def _config_kw(runtime, prefix, layout="paged"):
    return dict(max_batch=WORKLOAD["max_batch"], max_seq=WORKLOAD["max_seq"],
                runtime=runtime, kv_layout=layout,
                page_size=WORKLOAD["page_size"], prefix_cache=prefix,
                verbose=False)


def _serve(engine, prompts, request_cls):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=list(p),
                                  max_new_tokens=WORKLOAD["max_new"]))
    engine.run_until_done()
    return {r.rid: list(r.generated) for r in engine.finished}


def _pool_snapshot(pool, store):
    return types.SimpleNamespace(store=store, refcount=np.array(pool.refcount),
                                 free=list(pool.free))


@pytest.fixture(scope="module", params=ARCHS)
def jax_runs(request):
    """The JAX paged engine's tokens, stats and final pool for each
    (runtime, prefix cache) of ``RUNS`` on one reduced arch."""
    jax = pytest.importorskip("jax")
    from repro.config import get_config as jget, reduced as jreduced
    from repro.core.disagg import DisaggPlan as JPlan
    from repro.core.disagg import DisaggregatedInstance as JInst
    from repro.models import init_params as jinit
    from repro.serving.config import ServingConfig as JConfig
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import Request as JRequest

    cfg = jreduced(jget(request.param))
    params = jinit(cfg, jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab)
    runs = {}
    for runtime, prefix in RUNS:
        inst = (JInst(cfg, params, plan=JPlan(n_microbatches=WORKLOAD["microbatches"]))
                if runtime == "pingpong" else None)
        eng = JEngine(cfg, params, runtime=inst,
                      config=JConfig(**_config_kw(runtime, prefix)))
        tokens = _serve(eng, prompts, JRequest)
        st = eng.stats()
        runs[runtime, prefix] = types.SimpleNamespace(
            tokens=tokens, kv_pages=st["kv_pages"],
            prefix_cache=st.get("prefix_cache"),
            pool=_pool_snapshot(eng.page_pool,
                                jax.tree.map(np.asarray, eng.page_pool.store)))
    return types.SimpleNamespace(arch=request.param,
                                 params=jax.tree.map(np.asarray, params),
                                 jparams=params, jcfg=cfg, prompts=prompts,
                                 runs=runs)


def _port_engine(cfg, params, runtime, prefix, layout="paged"):
    sc = ServingConfig(microbatches=WORKLOAD["microbatches"], device="cpu",
                       **_config_kw(runtime, prefix, layout))
    inst = (DisaggregatedInstance(cfg, params, DisaggPlan(sc.microbatches))
            if runtime == "pingpong" else None)
    return Engine(cfg, params, config=sc, runtime=inst)


@pytest.mark.parametrize("runtime,prefix", RUNS)
def test_paged_engine_matches_jax(jax_runs, runtime, prefix):
    cfg = reduced(get_config(jax_runs.arch))
    params = params_from_jax(jax_runs.params, cfg, device="cpu")
    want = jax_runs.runs[runtime, prefix]
    eng = _port_engine(cfg, params, runtime, prefix)
    got = _serve(eng, jax_runs.prompts, Request)
    assert len(got) == WORKLOAD["n_requests"]
    assert got == want.tokens
    # the port's contiguous engine gives the same tokens
    contiguous = _serve(_port_engine(cfg, params, "monolithic", True,
                                     layout="contiguous"),
                        jax_runs.prompts, Request)
    assert got == contiguous
    st = eng.stats()
    assert st["kv_layout"] == "paged"
    assert st["kv_pages"] == want.kv_pages
    assert st.get("prefix_cache") == want.prefix_cache
    n = WORKLOAD["n_requests"]
    if prefix:
        assert st["prefix_cache"]["hits"] == n - 1
        assert st["prefix_cache"]["hit_tokens"] == (n - 1) * WORKLOAD["shared_prefix_len"]
        assert st["kv_pages"]["forks"] > 0          # the ring wrapped into a shared page
    # the pool afterwards: same pages held, same free order, same contents
    pool = eng.page_pool
    np.testing.assert_array_equal(pool.refcount, want.pool.refcount)
    assert list(pool.free) == want.pool.free
    assert pool.reserved == 0
    jstore = pages_from_jax(want.pool.store, cfg, device="cpu")
    for mine, theirs in zip(pool.store, jstore):
        assert torch.equal(mine["pos"], theirs["pos"])
        torch.testing.assert_close(mine["k"], theirs["k"], **TOL)
        torch.testing.assert_close(mine["v"], theirs["v"], **TOL)


def test_suffix_prefill_matches_jax(jax_runs):
    """After a prefix hit only the prompt's suffix is computed, as decode
    steps over the B = 1 row: logits and the row's KV agree with JAX."""
    from repro.models import prefill as jprefill
    from repro.serving.prefill import suffix_prefill as jsuffix
    import jax
    import jax.numpy as jnp
    prompt, start = jax_runs.prompts[1], WORKLOAD["shared_prefix_len"]
    _, row = jprefill(jax_runs.jparams, jax_runs.jcfg,
                      jnp.asarray([prompt[:start]], jnp.int32),
                      max_seq=WORKLOAD["max_seq"])
    want_logits, want_row = jsuffix(jax_runs.jparams, jax_runs.jcfg, prompt, row,
                                    start)
    cfg = reduced(get_config(jax_runs.arch))
    params = params_from_jax(jax_runs.params, cfg, device="cpu")
    port_row = cache_from_jax(jax.tree.map(np.asarray, row), cfg, device="cpu")
    logits, got_row = suffix_prefill(params, cfg, prompt, port_row, start)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    for mine, theirs in zip(got_row, cache_from_jax(
            jax.tree.map(np.asarray, want_row), cfg, device="cpu")):
        assert torch.equal(mine["pos"], theirs["pos"])
        torch.testing.assert_close(mine["k"], theirs["k"], **TOL)
    with pytest.raises(ValueError, match="no token"):
        suffix_prefill(params, cfg, prompt, port_row, len(prompt))


def test_paged_admission_waits_for_pages():
    """A pool too small for two requests' worst case admits them one at
    a time, in FIFO order, and still gives the contiguous tokens."""
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x22b")), n_layers=2)
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, 0, device="cpu")
    prompts = _prompts(cfg.vocab, seed=4)[:3]
    want = _serve(_port_engine(cfg, params, "monolithic", False, "contiguous"),
                  prompts, Request)
    sc = ServingConfig(device="cpu", kv_pool_pages=5,
                       **_config_kw("monolithic", False))
    eng = Engine(cfg, params, config=sc)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p),
                           max_new_tokens=WORKLOAD["max_new"]))
    eng.step()
    assert len(eng.running) == 1 and [r.rid for r in eng.waiting] == [1, 2]
    eng.run_until_done()
    assert {r.rid: r.generated for r in eng.finished} == want
    assert [r.rid for r in eng.finished] == [0, 1, 2]
    assert eng.page_pool.used == 0 and eng.page_pool.reserved == 0


def test_launcher_paged_run_matches_jax():
    """``launch.serve.run`` on the shared-prefix workload: the port draws
    the same prompts as the JAX launcher (shared prefix first), so the
    prefix-cache and page-pool counters of the measured requests agree,
    warm-up requests left out."""
    pytest.importorskip("jax")
    from repro.launch.serve import run as jrun
    from repro.serving.config import ServingConfig as JConfig
    from repro_torch.launch.serve import run
    kw = dict(use_reduced=True, runtime="monolithic", kv_layout="paged",
              page_size=8, prompt_len=32, shared_prefix_len=24, n_requests=5,
              max_new=3, max_batch=4, max_seq=64, warmup_requests=1,
              verbose=False)
    want = jrun(config=JConfig(**kw))
    got = run(config=ServingConfig(device="cpu", **kw))
    assert got["tokens"] == want["tokens"] == 15
    assert got["decode_iters"] == want["decode_iters"]
    assert got["prefix_cache"] == want["prefix_cache"]
    assert got["prefix_cache"]["hits"] == 5        # the warm-up seeded the tree
    for k in ("used", "high_water", "allocs", "forks", "released"):
        assert got["kv_pages"][k] == want["kv_pages"][k], k
