"""The paged KV layout under the M2N dispatch and under live expert
rebalancing, against the JAX package's engine on the CPU (the JAX
package's ``tests/test_paged_serving.py`` ``test_pingpong_m2n_parity``
and ``test_parity_across_live_rebalance``).

Reduced mixtral-8x22b and dbrx serve prompts that open with a two-page
shared prefix (so the radix cache hits) through the ping-pong runtime
with the paged cache, prefix cache on: with m2n, rebalanced every 2
decode iterations, and both.  Required: greedy tokens identical to the JAX
paged engine's and to the port's contiguous engine's; the prefix-cache,
page-pool and expert-balance counters equal to JAX's.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config, reduced
from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine, Request

torch.set_num_threads(1)

PS = 8
# (use_m2n, expert_rebalance_every)
RUNS = {"m2n": (True, 0), "rebalanced": (False, 2), "m2n+rebalanced": (True, 2)}


def _prompts(vocab, n=6, seed=17):
    rng = np.random.RandomState(seed)
    head = rng.randint(2, vocab, size=2 * PS).tolist()
    return [head + rng.randint(2, vocab, size=rng.randint(3, 10)).tolist()
            for _ in range(n)]


def _config_kw(m2n, every, layout="paged"):
    return dict(max_batch=3, max_seq=64, page_size=PS, kv_layout=layout,
                runtime="pingpong", microbatches=2, use_m2n=m2n,
                expert_rebalance_every=every, verbose=False)


def _serve(engine, prompts, request_cls):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=list(p), max_new_tokens=5))
    engine.run_until_done(max_iters=500)
    return {r.rid: list(r.generated) for r in engine.finished}


STAT_KEYS = ("prefix_cache", "kv_pages", "expert_loads", "rebalances",
             "placement_updates", "replicated_experts", "decode_iters")


@pytest.fixture(scope="module", params=["mixtral-8x22b", "dbrx"])
def jax_runs(request):
    """The JAX paged ping-pong engine once per case of RUNS, on one
    reduced arch."""
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
    for name, (m2n, every) in RUNS.items():
        inst = JInst(cfg, params, plan=JPlan(n_microbatches=2, use_m2n=m2n))
        eng = JEngine(cfg, params, runtime=inst,
                      config=JConfig(**_config_kw(m2n, every)))
        tokens = _serve(eng, prompts, JRequest)
        st = eng.stats()
        runs[name] = types.SimpleNamespace(tokens=tokens,
                                           stats={k: st[k] for k in STAT_KEYS})
    return types.SimpleNamespace(arch=request.param,
                                 params=jax.tree.map(np.asarray, params),
                                 prompts=prompts, runs=runs)


@pytest.fixture(scope="module")
def port(jax_runs):
    cfg = reduced(get_config(jax_runs.arch))
    params = params_from_jax(jax_runs.params, cfg, device="cpu")
    contiguous = Engine(cfg, params, config=ServingConfig(
        device="cpu", **_config_kw(False, 0, "contiguous")),
        runtime=DisaggregatedInstance(cfg, params, DisaggPlan(2)))
    return types.SimpleNamespace(
        cfg=cfg, params=params,
        contiguous=_serve(contiguous, jax_runs.prompts, Request))


@pytest.mark.parametrize("name", list(RUNS))
def test_paged_pingpong_matches_jax(jax_runs, port, name):
    m2n, every = RUNS[name]
    want = jax_runs.runs[name]
    inst = DisaggregatedInstance(port.cfg, port.params,
                                 DisaggPlan(2, use_m2n=m2n))
    eng = Engine(port.cfg, port.params,
                 config=ServingConfig(device="cpu", **_config_kw(m2n, every)),
                 runtime=inst)
    got = _serve(eng, jax_runs.prompts, Request)
    assert len(got) == len(jax_runs.prompts)
    assert got == want.tokens == port.contiguous
    st = eng.stats()
    for k in STAT_KEYS:
        assert st[k] == want.stats[k], k
    assert st["prefix_cache"]["hits"] > 0
    if every:
        assert st["rebalances"] > 0 and inst.tables is not None
    if m2n:
        assert st["stages"]["m2n_n"] == st["stages"]["n2m_n"] > 0
