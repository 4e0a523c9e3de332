"""The port's M2N dispatch (``repro_torch.core.m2n``) against the JAX
package, on the CPU at reduced sizes.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the dispatch runs the plain versions of its kernels
(``gating_dispatch`` with the owner filter and the placement tables,
the grouped MLP).  Tolerances:
  * routed-expert outputs against the JAX dense oracle
    (``moe.routed_experts_dense``): rtol = atol = 1e-4, the tolerance of
    the JAX package's own m2n-vs-dense test (the shards' partials are
    summed in another order);
  * routing counts: exact (sums of 0/1 weights);
  * decode_step logits under ``use_m2n``: rtol = atol = 5e-4, the JAX
    package's runtime-parity tolerance.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.config import MoEConfig, get_config, reduced
from repro_torch.core import load_balance as lb
from repro_torch.core import m2n
from repro_torch.core.transport import InProcessTransport
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import config as jconfig
    from repro.core import m2n as jm2n
    from repro.models import moe as jmoe
    from repro.models import transformer as jtf
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig, m2n=jm2n,
                                 moe=jmoe, tf=jtf)


def _case(E=6, d=8, f=16, T=32, seed=0):
    """Router and expert weights, tokens and (E,) router bias from numpy."""
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(d, E).astype(np.float32),
         "we1": (rng.randn(E, d, f) * 0.2).astype(np.float32),
         "we3": (rng.randn(E, d, f) * 0.2).astype(np.float32),
         "we2": (rng.randn(E, f, d) * 0.2).astype(np.float32),
         "router_bias": np.linspace(-0.5, 0.5, E).astype(np.float32)}
    return p, rng.randn(T, d).astype(np.float32)


def _placed(p, N, E):
    """Weights gathered to the (N*S, ...) virtual slots of a placement
    with a hot expert 0 (replicated), and the tables as tensors."""
    e_loc = -(-E // N)
    S = min(E, max(e_loc, round(e_loc * 2.0)))
    tables = lb.placement_tables(
        lb.balance_experts([60.0] + [4.0] * (E - 1), N), S)
    assert (tables.fractions > 1e-9).sum(axis=1).max() > 1   # replicated
    gather = np.where(tables.slot_experts.reshape(-1) < 0, 0,
                      tables.slot_experts.reshape(-1))
    placed = {k: torch.from_numpy(p[k][gather]) for k in ("we1", "we3", "we2")}
    tk = {"rep_node": torch.from_numpy(tables.rep_node),
          "rep_slot": torch.from_numpy(tables.rep_slot),
          "rep_cum": torch.from_numpy(tables.rep_cum), "slots_per_node": S}
    return placed, tk


@pytest.mark.parametrize("tables", [False, True])
def test_sharded_routed_experts_match_jax_dense(jx, tables):
    """E = 6 experts over N = 4 shards (padded to 8 buckets without the
    tables), top-2, against the JAX dense oracle; the counts equal JAX
    ``routing_counts`` of the same routing."""
    E, N, K = 6, 4, 2
    p, x = _case(E)
    cfg = MoEConfig(n_experts=E, top_k=K, d_ff_expert=16)
    jcfg = jx.config.MoEConfig(n_experts=E, top_k=K, d_ff_expert=16)
    jp = {k: jx.jnp.asarray(v) for k, v in p.items()}
    want, _ = jx.moe.routed_experts_dense(jp, jx.jnp.asarray(x), jcfg, "silu",
                                          "full")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tk = None
    if tables:
        placed, tk = _placed(p, N, E)
        tp.update(placed)
    got, counts = m2n.sharded_routed_experts(
        tp, torch.from_numpy(x), cfg, "silu", "full", n_shards=N, tables=tk,
        with_counts=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    routing = jx.moe.route(jx.jnp.asarray(x), jp["router"], K,
                           jp["router_bias"])
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jx.moe.routing_counts(routing, E)))


@pytest.mark.parametrize("T,d,N,itemsize", [(4, 6144, 4, 2), (32, 8, 4, 4),
                                            (7, 256, 3, 2)])
def test_combine_bytes_are_the_m2n_traffic(jx, T, d, N, itemsize):
    """The dispatch puts one ``collective`` hop of the M2N combine's
    analytic bytes on the transport, and the port's traffic model equals
    the JAX package's."""
    want = jx.m2n.m2n_traffic_bytes(T, d, 2, 8, N, itemsize)
    assert m2n.m2n_traffic_bytes(T, d, 2, 8, N, itemsize) == want
    E = 8
    p, x = _case(E, d=d, T=T, seed=T)
    dt = torch.bfloat16 if itemsize == 2 else torch.float32
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tp.update({k: tp[k].to(dt) for k in ("we1", "we3", "we2")})
    tr = InProcessTransport()
    m2n.sharded_routed_experts(tp, torch.from_numpy(x).to(dt),
                               MoEConfig(n_experts=E, top_k=2, d_ff_expert=16),
                               "silu", "full", n_shards=N, transport=tr)
    st = tr.stats()
    assert st["collective"]["hops"] == 1
    assert st["collective"]["bytes"] == int(want["m2n"])
    assert set(st) == {"backend", "collective"}


def test_weights_2d_is_refused():
    p, x = _case()
    with pytest.raises(NotImplementedError, match="weights_2d"):
        m2n.sharded_routed_experts(
            {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
            MoEConfig(n_experts=6, top_k=2, d_ff_expert=16), "silu", "full",
            n_shards=4, weights_2d=True)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_use_m2n_decode_step_matches_jax(jx, n_shards):
    """``use_m2n`` around the port's monolithic decode_step (reduced
    mixtral: 4 experts, top-2; 3 shards pad them to 6 buckets) gives the
    JAX decode_step's logits and greedy tokens over two steps, and the
    routed-expert hook is restored after the block."""
    jcfg = jx.config.reduced(jx.config.get_config("mixtral-8x22b"))
    tcfg = reduced(get_config("mixtral-8x22b"))
    params_j = jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))
    params_t = params_from_jax(jx.jax.tree.map(np.asarray, params_j), tcfg,
                               device="cpu")
    B, T = 3, 6
    toks = np.random.RandomState(1).randint(0, tcfg.vocab, (B, T)).astype(np.int32)
    lj, cj = jx.tf.prefill(params_j, jcfg, jx.jnp.asarray(toks), max_seq=16)
    ct = cache_from_jax(jx.jax.tree.map(np.asarray, cj), tcfg, device="cpu")
    nj = np.asarray(jx.jnp.argmax(lj, -1)).astype(np.int32)
    pos = np.full((B,), T, np.int32)
    tr = InProcessTransport()
    for _ in range(2):
        lj, cj = jx.tf.decode_step(params_j, jcfg, jx.jnp.asarray(nj), cj,
                                   jx.jnp.asarray(pos))
        with m2n.use_m2n(n_shards, transport=tr):
            lt, ct = ttf.decode_step(params_t, tcfg, torch.from_numpy(nj), ct,
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        nj = np.asarray(jx.jnp.argmax(lj, -1)).astype(np.int32)
        np.testing.assert_array_equal(lt.argmax(-1).numpy(), nj)
        pos = pos + 1
    assert tmoe._ROUTED_IMPL is None
    hops = tr.stats().get("collective", {"hops": 0})["hops"]
    assert hops == (2 * tcfg.n_layers if n_shards > 1 else 0)
