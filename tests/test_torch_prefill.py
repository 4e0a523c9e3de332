"""The port's prefill cluster (``serving.prefill.PrefillWorker``), its KV
hops and the stats schema against the JAX package, on the CPU.

  * the worker's queue mechanics with a fake ``prefill_fn`` (the JAX
    package's ``tests/test_prefill_disagg.py`` cases): FIFO order and
    the greedy first token, same-length batching under the chunk budget,
    the chunk split, mixed lengths never batched, ``pump(max_batches)``;
    and the same batches and queue order as the JAX worker on random
    request streams;
  * ``migrate_kv`` equals ``insert_rows``, ``migrate_pages`` equals
    ``write_row_span``, each hop counted in the ledger;
  * the engine with a prefill worker gives the JAX engine's greedy
    tokens, monolithic and ping-pong under ``sync`` and ``async``, and
    for batched same-length prompts, with the JAX phase counts;
  * the paged worker makes one "kv" hop per migrated page, the same hops
    and bytes as the JAX ledger (``tests/test_paged_serving.py:202-240``),
    and with a warm prefix cache moves only the suffix page;
  * ``Engine.stats()`` carries every key of the JAX payload with the
    same type, ``schema_version`` 4.
"""
import random
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config, reduced
from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
from repro_torch.core.transport import InProcessTransport, tree_nbytes
from repro_torch.models.transformer import init_cache, init_params, prefill
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kvcache import (extract_row, insert_rows, migrate_kv,
                                         migrate_pages)
from repro_torch.serving.pages import PagePool, row_to_page_chunks
from repro_torch.serving.prefill import PrefillWorker

torch.set_num_threads(1)

PS = 8
MAX_SEQ = 64


def _fake_prefill(params, cfg, tokens, max_seq, **kw):
    """Stand-in prefill for the queue tests: last-position logits one-hot
    at the last prompt token (so the greedy first token equals it), and a
    one-layer cache whose marker is the first prompt token (a row mix-up
    shows)."""
    logits = torch.nn.functional.one_hot(tokens[:, -1], cfg.vocab).float()
    return logits, [{"marker": tokens[:, :1].to(torch.int32)}]


def _fake_worker(cfg, **kw):
    return PrefillWorker(cfg, {}, max_seq=MAX_SEQ, prefill_fn=_fake_prefill,
                         device="cpu", **kw)


def _prompts(vocab, n=6, seed=0, lengths=None, shared=0):
    rng = np.random.RandomState(seed)
    head = rng.randint(2, vocab, size=shared).tolist()
    return [head + rng.randint(2, vocab, size=(lengths[i % len(lengths)]
                                               if lengths
                                               else rng.randint(2, 10))).tolist()
            for i in range(n)]


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("mixtral-8x22b"))


# ------------------------------------------------------------------ worker
def test_fifo_order_and_greedy_first_token(cfg):
    w = _fake_worker(cfg)
    prompts = _prompts(cfg.vocab, n=8, seed=1)
    for i, p in enumerate(prompts):
        w.submit(Request(rid=i, prompt=p))
    assert w.pending_count == 8 and w.ready_count == 0
    w.pump()
    assert w.pending_count == 0 and w.ready_count == 8
    for i, p in enumerate(prompts):
        res = w.pop()
        assert res.request.rid == i
        assert int(res.first_token) == p[-1]
        assert int(res.kv[0]["marker"][0, 0]) == p[0]
        assert res.n_prompt_tokens == len(p)
    assert w.pop() is None


@pytest.mark.parametrize("chunk,n_batches", [(64, 1), (8, 3), (4, 6)])
def test_same_length_prompts_batch_under_budget(cfg, chunk, n_batches):
    """6 prompts of 4 tokens: one call within 64 tokens, two prompts a
    call within 8, one within 4; FIFO either way."""
    w = _fake_worker(cfg, chunk_tokens=chunk)
    for i, p in enumerate(_prompts(cfg.vocab, n=6, lengths=[4])):
        w.submit(Request(rid=i, prompt=p))
    w.pump()
    assert w.n_batches == n_batches and w.n_prefills == 6
    assert [w.pop().request.rid for _ in range(6)] == list(range(6))


def test_mixed_lengths_never_share_a_batch(cfg):
    w = _fake_worker(cfg)
    for i, p in enumerate(_prompts(cfg.vocab, n=4, lengths=[3, 7])):
        w.submit(Request(rid=i, prompt=p))
    w.pump()
    assert w.n_batches == 4
    assert [w.pop().request.rid for _ in range(4)] == list(range(4))


def test_pump_max_batches_bounds_work(cfg):
    w = _fake_worker(cfg)
    for i, p in enumerate(_prompts(cfg.vocab, n=5, lengths=[3, 7])):
        w.submit(Request(rid=i, prompt=p))
    assert w.pump(max_batches=2) == 2
    assert w.ready_count == 2 and w.pending_count == 3
    w.pump()
    assert w.ready_count == 5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.config import get_config as jget, reduced as jreduced
    from repro.core import disagg as jdisagg
    from repro.models import init_params as jinit
    from repro.serving import config as jconfig
    from repro.serving import engine as jengine
    from repro.serving import prefill as jprefill
    jcfg = jreduced(jget("mixtral-8x22b"))
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=jcfg, params=jparams, disagg=jdisagg,
        config=jconfig, engine=jengine, prefill=jprefill,
        np_params=jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("seed", range(6))
def test_worker_batches_like_jax(jx, cfg, seed):
    """Random request streams, submitted and pumped in random steps: the
    same batches, the same FIFO queue and first tokens as the JAX worker
    with the same fake prefill."""
    def jfake(params, c, tokens, max_seq, **kw):
        logits = jx.jax.nn.one_hot(tokens[:, -1], c.vocab)
        return logits, {"blocks": (), "remainder": (
            {"marker": tokens[:, :1].astype(jx.jnp.int32)},)}
    rng = random.Random(seed)
    chunk = rng.choice([1, 4, 8, 16, 32])
    plens = [rng.choice([2, 3, 4, 9]) for _ in range(rng.randint(4, 16))]
    prompts = [[rng.randrange(2, cfg.vocab) for _ in range(n)] for n in plens]
    w = _fake_worker(cfg, chunk_tokens=chunk)
    jw = jx.prefill.PrefillWorker(jx.cfg, {}, max_seq=MAX_SEQ, chunk_tokens=chunk,
                                  prefill_fn=jfake)
    got, want, i = [], [], 0
    while i < len(prompts) or w.pending_count:
        for _ in range(rng.randint(0, 3)):
            if i < len(prompts):
                w.submit(Request(rid=i, prompt=prompts[i]))
                jw.submit(jx.engine.Request(rid=i, prompt=prompts[i]))
                i += 1
        n = rng.choice([None, 1, 2])
        assert w.pump(max_batches=n) == jw.pump(max_batches=n)
        assert (w.n_batches, w.ready_count) == (jw.n_batches, jw.ready_count)
        while rng.random() < 0.5 and w.ready_count:
            r, jr = w.pop(), jw.pop()
            got.append((r.request.rid, int(r.first_token), r.n_prompt_tokens))
            want.append((jr.request.rid, int(jr.first_token), jr.n_prompt_tokens))
    assert got == want
    assert w.stats()["prefill_batches"] == jw.stats()["prefill_batches"]


# ---------------------------------------------------------------- transfer
def test_migrate_kv_equals_insert_rows(cfg):
    params = init_params(cfg, 3, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 6),
                         generator=torch.Generator().manual_seed(3))
    _, rcache = prefill(params, cfg, toks, max_seq=32)
    want = insert_rows(init_cache(cfg, 4, 32, device="cpu"), rcache, 2)
    for sync in (False, True):
        tr = InProcessTransport()
        got = migrate_kv(init_cache(cfg, 4, 32, device="cpu"), rcache, 2,
                         sync=sync, transport=tr)
        for a, b in zip(got, want):
            for k in a:
                assert torch.equal(a[k], b[k])
        assert tr.stats()["kv"] == {"hops": 1, "bytes": tree_nbytes(rcache),
                                    "issue_s": tr.stats()["kv"]["issue_s"],
                                    "sim_s": 0.0}
    # extract_row is the inverse of insert_rows
    for a, b in zip(extract_row(want, 2), rcache):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_migrate_pages_equals_write_row_span(cfg):
    params = init_params(cfg, 4, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 21),
                         generator=torch.Generator().manual_seed(4))
    _, row = prefill(params, cfg, toks, max_seq=MAX_SEQ)
    pools = [PagePool(cfg, n_pages=12, page_size=PS, max_seq=MAX_SEQ, device="cpu")
             for _ in range(2)]
    pages = [[p.alloc() for _ in range(3)] for p in pools]
    pools[0].write_row_span(pages[0][1:], row, PS, 21)
    chunks = row_to_page_chunks(row, PS, 21, PS)
    assert [lp for lp, _ in chunks] == [1, 2]
    tr = InProcessTransport()
    migrate_pages(pools[1], chunks, pages[1][1:], transport=tr)
    for a, b in zip(pools[0].store, pools[1].store):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert tr.stats()["kv"]["hops"] == 2
    assert tr.stats()["kv"]["bytes"] == 2 * tree_nbytes(chunks[0][1])
    with pytest.raises(ValueError, match="pages for"):
        migrate_pages(pools[1], chunks, pages[1][:1], transport=tr)


# ------------------------------------------------------------------ engine
def _serve(engine, prompts, request_cls, max_new=5):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=list(p), max_new_tokens=max_new))
    engine.run_until_done(max_iters=500)
    return {r.rid: list(r.generated) for r in engine.finished}


def _sc_kw(**kw):
    base = dict(max_batch=3, max_seq=MAX_SEQ, page_size=PS, verbose=False)
    base.update(kw)
    return base


# (name, runtime, prompt kwargs, worker kwargs, layout kwargs)
JAX_RUNS = {
    "monolithic": ("monolithic", dict(seed=11), {}, {}),
    "pingpong": ("pingpong", dict(seed=13), {}, {}),
    "batched": ("monolithic", dict(seed=17, lengths=[5]), dict(chunk_tokens=64), {}),
    "paged": ("monolithic", dict(n=5, seed=41), {},
              dict(kv_layout="paged", prefix_cache=False)),
}


@pytest.fixture(scope="module")
def jax_runs(jx):
    """The JAX engine with a PrefillWorker, once per case of JAX_RUNS:
    tokens and stats."""
    out = {}
    for name, (runtime, pkw, wkw, lkw) in JAX_RUNS.items():
        prompts = _prompts(jx.cfg.vocab, **pkw)
        sc = jx.config.ServingConfig(**_sc_kw(runtime=runtime, microbatches=2,
                                              **lkw))
        inst = (jx.disagg.DisaggregatedInstance(
            jx.cfg, jx.params, plan=jx.disagg.DisaggPlan(n_microbatches=2))
            if runtime == "pingpong" else None)
        w = jx.prefill.PrefillWorker(
            jx.cfg, jx.params, max_seq=MAX_SEQ,
            page_size=PS if lkw else 0, **wkw)
        eng = jx.engine.Engine(jx.cfg, jx.params, config=sc, runtime=inst,
                               prefill_worker=w)
        out[name] = types.SimpleNamespace(
            prompts=prompts, tokens=_serve(eng, prompts, jx.engine.Request),
            stats=eng.stats())
    return out


@pytest.fixture(scope="module")
def port_params(jx, cfg):
    return params_from_jax(jx.np_params, cfg, device="cpu")


def _port_engine(cfg, params, runtime, transfer="async", wkw=None, **lkw):
    sc = ServingConfig(device="cpu", microbatches=2, transfer=transfer,
                       **_sc_kw(runtime=runtime, **lkw))
    inst = (DisaggregatedInstance(cfg, params, DisaggPlan(2))
            if runtime in ("pingpong", "disagg") else None)
    w = PrefillWorker(cfg, params, max_seq=MAX_SEQ,
                      page_size=PS if sc.kv_layout == "paged" else 0,
                      **(wkw or {}))
    return Engine(cfg, params, config=sc, runtime=inst, prefill_worker=w)


COUNTED = ("prefills", "prefill_batches", "prefill_tokens", "prefill_devices",
           "transfer_n", "decode_n")


@pytest.mark.parametrize("transfer", ["sync", "async"])
@pytest.mark.parametrize("name", ["monolithic", "pingpong", "batched"])
def test_prefill_worker_engine_matches_jax(jax_runs, cfg, port_params, name,
                                           transfer):
    runtime, _, wkw, lkw = JAX_RUNS[name]
    want = jax_runs[name]
    eng = _port_engine(cfg, port_params, runtime, transfer, wkw, **lkw)
    got = _serve(eng, want.prompts, Request)
    assert got == want.tokens
    # the inline-prefill engine gives the same tokens
    inline = Engine(cfg, port_params, config=ServingConfig(
        device="cpu", **_sc_kw(runtime="monolithic")))
    assert _serve(inline, want.prompts, Request) == got
    st = eng.stats()
    assert st["disagg_prefill"] and st["phases"]["transfer_mode"] == transfer
    for k in COUNTED:
        assert st["phases"][k] == want.stats["phases"][k], k
    assert st["transport"]["kv"]["hops"] == want.stats["transport"]["kv"]["hops"]
    assert st["transport"]["kv"]["bytes"] == want.stats["transport"]["kv"]["bytes"]
    if name == "batched":
        assert st["phases"]["prefill_batches"] < len(want.prompts)


@pytest.mark.parametrize("transfer", ["sync", "async"])
def test_paged_worker_hops_per_page_like_jax(jax_runs, cfg, port_params, transfer):
    want = jax_runs["paged"]
    eng = _port_engine(cfg, port_params, "monolithic", transfer,
                       kv_layout="paged", prefix_cache=False)
    got = _serve(eng, want.prompts, Request)
    assert got == want.tokens
    kv, jkv = eng.stats()["transport"]["kv"], want.stats["transport"]["kv"]
    assert kv["hops"] == sum(-(-len(p) // PS) for p in want.prompts)
    assert (kv["hops"], kv["bytes"]) == (jkv["hops"], jkv["bytes"])
    assert eng.page_pool.used == 0 and eng.page_pool.reserved == 0


def test_warm_prefix_cache_moves_only_the_suffix_page(jx, cfg, port_params):
    """A warm-up request seeds the radix tree; then every prompt (16
    shared tokens, a tail of 1-8) hits the two shared pages, and only
    its third page crosses to the decode side: tokens, hits and ledger
    equal to the JAX engine's."""
    rng = np.random.RandomState(43)
    shared = rng.randint(2, cfg.vocab, size=2 * PS).tolist()
    prompts = [shared + rng.randint(2, cfg.vocab, size=n).tolist()
               for n in (1, 8, 5, 3)]
    warm = shared + [7, 9, 11]

    def drive(eng, request_cls):
        eng.submit(request_cls(rid=100, prompt=warm, max_new_tokens=2))
        eng.run_until_done(max_iters=100)
        cold = eng.stats()["transport"]["kv"]["bytes"]
        toks = _serve(eng, prompts, request_cls, max_new=3)
        st = eng.stats()
        return toks, st, st["transport"]["kv"]["bytes"] - cold, eng

    sc = jx.config.ServingConfig(**_sc_kw(kv_layout="paged"))
    jw = jx.prefill.PrefillWorker(jx.cfg, jx.params, max_seq=MAX_SEQ, page_size=PS)
    want, jst, jwarm, _ = drive(jx.engine.Engine(jx.cfg, jx.params, config=sc,
                                                 prefill_worker=jw),
                                jx.engine.Request)
    got, st, warm_bytes, eng = drive(_port_engine(cfg, port_params, "monolithic",
                                                  kv_layout="paged"), Request)
    assert got == want
    assert st["prefix_cache"]["hits"] == jst["prefix_cache"]["hits"] == 4
    assert (st["transport"]["kv"]["hops"], warm_bytes) == \
        (jst["transport"]["kv"]["hops"], jwarm)
    # the warm-up request moved its 3 pages, each later one its third page
    assert st["transport"]["kv"]["hops"] == 3 + len(prompts)
    page = [{k: t[0] for k, t in e.items()} for e in eng.page_pool.store]
    assert warm_bytes == len(prompts) * tree_nbytes(page)
    assert st["phases"]["prefill_tokens"] == len(warm) + sum(
        len(p) - 2 * PS for p in prompts)


def test_bad_transfer_mode_rejected():
    with pytest.raises(ValueError, match="transfer"):
        ServingConfig(transfer="dma")
    with pytest.raises(ValueError, match="prefill_devices"):
        ServingConfig(prefill_devices=-1)


# ------------------------------------------------------------------- stats
def _same_shape(got, want, path="stats"):
    """Every key of ``want`` is in ``got`` with a value of the same type,
    nested dicts compared key by key."""
    for k, v in want.items():
        assert k in got, f"{path}.{k} missing"
        if isinstance(v, dict):
            _same_shape(got[k], v, f"{path}.{k}")
        elif isinstance(v, bool) or isinstance(got[k], bool):
            assert type(got[k]) is type(v), f"{path}.{k}"
        elif isinstance(v, (int, np.integer)):
            assert isinstance(got[k], (int, np.integer)), f"{path}.{k}"
        elif isinstance(v, (float, np.floating)):
            assert isinstance(got[k], (float, np.floating)), f"{path}.{k}"
        else:
            assert type(got[k]) is type(v), f"{path}.{k}: {type(got[k])}"
            if isinstance(v, list):
                assert len(got[k]) == len(v), f"{path}.{k}"


@pytest.mark.parametrize("name", ["pingpong", "paged"])
def test_stats_carry_every_jax_key(jax_runs, cfg, port_params, name):
    from repro.serving.stats import STATS_SCHEMA_VERSION as JVERSION
    from repro_torch.serving.stats import STATS_SCHEMA_VERSION
    runtime, _, wkw, lkw = JAX_RUNS[name]
    want = jax_runs[name].stats
    eng = _port_engine(cfg, port_params, runtime, "async", wkw, **lkw)
    _serve(eng, jax_runs[name].prompts, Request)
    st = eng.stats()
    assert st["schema_version"] == want["schema_version"] == JVERSION == \
        STATS_SCHEMA_VERSION == 4
    _same_shape(st, want)
    assert set(st) - set(want) == {"device", "kernel_launches"}
    assert st["use_kernels"] is False and st["device"] == "cpu"
