"""The port's paged KV pool and radix prefix cache (``repro_torch.serving
.pages`` / ``prefix_cache``) on the CPU.

Pool invariants under a fixed random sequence of operations, the
gather / ``write_row_span`` round trip over shuffled pages with unmapped
tails, copy-on-write across every layer, the per-token write-back, and
the prefix cache against the JAX package's ``PrefixCache`` under the
same sequence of lookups, inserts and evictions (same results, same
``stats()``, same refcounts).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import get_config, reduced
from repro_torch.models.transformer import init_cache
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.pages import (PageError, PagePool, n_pages_for,
                                       paged_supported)
from repro_torch.serving.prefix_cache import PrefixCache

torch.set_num_threads(1)

PS, MAX_SEQ = 8, 32


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(reduced(get_config("mixtral-8x22b")), n_layers=2)


def _pool(cfg, n_pages=12):
    return PagePool(cfg, n_pages=n_pages, page_size=PS, max_seq=MAX_SEQ,
                    device="cpu")


def _random_row(cfg, n_tokens, seed):
    """A one-request dense cache (per layer (1, W, ...)) holding
    positions 0..n_tokens-1 and random K/V."""
    g = torch.Generator().manual_seed(seed)
    row = init_cache(cfg, 1, MAX_SEQ, device="cpu")
    for entry in row:
        entry["k"].normal_(generator=g)
        entry["v"].normal_(generator=g)
        entry["pos"][0, :n_tokens] = torch.arange(n_tokens, dtype=torch.int32)
    return row


def _check_accounting(pool):
    held = int((pool.refcount > 0).sum())
    assert len(pool.free) + held == pool.n_pages
    assert all(pool.refcount[p] == 0 for p in pool.free)
    assert len(set(pool.free)) == len(pool.free)
    assert 0 <= pool.reserved <= len(pool.free)


def test_pool_invariants_under_random_ops(cfg):
    pool = _pool(cfg)
    rng = np.random.RandomState(3)
    held = []                            # one entry per reference we own
    for _ in range(400):
        op = rng.randint(6)
        if op == 0 and pool.available > 0:
            held.append(pool.alloc())
        elif op == 1 and held:
            pool.release(held.pop(rng.randint(len(held))))
        elif op == 2 and held:
            p = held[rng.randint(len(held))]
            pool.retain(p)
            held.append(p)
        elif op == 3:
            n, avail = rng.randint(0, 4), pool.available
            assert pool.reserve(n) == (n <= avail)
        elif op == 4 and pool.reserved:
            if rng.rand() < 0.5:
                pool.unreserve(1)
            else:
                held.append(pool.alloc(from_reserve=True))
        elif op == 5 and held and (pool.available > 0 or pool.reserved):
            i = rng.randint(len(held))
            if pool.is_shared(held[i]):
                held[i] = pool.fork(held[i], from_reserve=pool.available <= 0)
        _check_accounting(pool)
        assert sorted(held) == sorted(
            p for p in range(pool.n_pages) for _ in range(pool.refcount[p]))
    assert pool.stats()["forks"] > 0
    for p in held:
        pool.release(p)
    assert pool.used == 0
    with pytest.raises(PageError):
        pool.release(pool.free[0])
    with pytest.raises(PageError):
        pool.unreserve(pool.reserved + 1)
    pool.unreserve(pool.reserved)
    assert pool.reserve(2)
    while pool.available > 0:
        pool.alloc()
    with pytest.raises(PageError, match="out of pages"):
        pool.alloc()
    assert not pool.reserve(1)
    pool.alloc(from_reserve=True)                 # reserved pages stay allocatable


def test_alloc_resets_pos_in_every_layer(cfg):
    pool = _pool(cfg, n_pages=1)
    p = pool.alloc()
    pool.write_row_span([p], _random_row(cfg, PS, 0), 0, PS)
    assert all(bool((e["pos"][p] >= 0).all()) for e in pool.store)
    pool.release(p)
    assert pool.alloc() == p
    for entry in pool.store:
        assert bool((entry["pos"][p] == -1).all())
        assert bool(entry["k"][p].abs().sum() > 0)      # stale bytes stay


@pytest.mark.parametrize("n_tokens", [5, 8, 21, 32])
def test_gather_round_trips_write_row_span(cfg, n_tokens):
    """A row written into shuffled pages gathers back bit for bit: the
    covered slots hold the row, everything past the written pages reads
    ``pos = -1``, and a batch of tables gathers each row independently."""
    pool = _pool(cfg, n_pages=16)
    rng = np.random.RandomState(n_tokens)
    for _ in range(rng.randint(1, 6)):   # shuffle the free list
        pool.free.rotate(rng.randint(1, 8))
    rows, chains = [], []
    for seed in range(2):
        row = _random_row(cfg, n_tokens, seed)
        pages = [pool.alloc() for _ in range(n_pages_for(n_tokens, PS))]
        pool.write_row_span(pages, row, 0, n_tokens)
        rows.append(row)
        chains.append(pages)
    bt = np.full((3, pool.n_logical), -1, np.int32)
    for i, pages in enumerate(chains):
        bt[i, :len(pages)] = pages
    dense = pool.gather(bt)
    covered = len(chains[0]) * PS
    for layer, entry in enumerate(dense):
        for i, row in enumerate(rows):
            want_pos = row[layer]["pos"][0].clone()
            want_pos[covered:] = -1
            assert torch.equal(entry["pos"][i], want_pos)
            assert torch.equal(entry["k"][i, :covered], row[layer]["k"][0, :covered])
            assert torch.equal(entry["v"][i, :covered], row[layer]["v"][0, :covered])
        assert bool((entry["pos"][2] == -1).all())      # fully unmapped row
    one = pool.gather_row(chains[1])
    for a, b in zip(one, dense):
        for key in a:
            assert torch.equal(a[key][0], b[key][1])


def test_write_row_span_from_a_page_boundary(cfg):
    """A prefix hit writes only the suffix pages: the span starts at a
    page boundary and the earlier pages stay as they were."""
    pool = _pool(cfg)
    row = _random_row(cfg, 20, 1)
    head = [pool.alloc() for _ in range(2)]
    pool.write_row_span(head, row, 0, 16)
    before = [{k: t[head].clone() for k, t in e.items()} for e in pool.store]
    tail = [pool.alloc()]
    pool.write_row_span(tail, row, 16, 20)
    for e, b in zip(pool.store, before):
        for key in e:
            assert torch.equal(e[key][head], b[key])
    got = pool.gather_row(head + tail)
    for g, r in zip(got, row):
        assert torch.equal(g["pos"][0, :20], r["pos"][0, :20])
        assert bool((g["pos"][0, 20:] == -1).all())
    with pytest.raises(PageError, match="page-aligned"):
        pool.write_row_span(tail, row, 12, 20)
    with pytest.raises(PageError, match="chunks"):
        pool.write_row_span(tail, row, 0, 20)


def test_fork_copies_every_layer_and_keeps_the_source(cfg):
    pool = _pool(cfg)
    src = pool.alloc()
    pool.write_row_span([src], _random_row(cfg, PS, 2), 0, PS)
    pool.retain(src)                                  # a second holder
    before = [{k: t[src].clone() for k, t in e.items()} for e in pool.store]
    new = pool.fork(src)
    assert new != src and pool.refcount[src] == 1 and pool.refcount[new] == 1
    assert pool.stats()["forks"] == 1
    for e, b in zip(pool.store, before):
        for key in ("k", "v", "pos"):
            assert torch.equal(e[key][new], b[key])
            assert torch.equal(e[key][src], b[key])
    # writing the fork leaves the source untouched
    for e in pool.store:
        e["k"][new].zero_()
        e["pos"][new, 0] = 99
    for e, b in zip(pool.store, before):
        assert torch.equal(e["k"][src], b["k"]) and torch.equal(e["pos"][src], b["pos"])
    with pytest.raises(PageError, match="free page"):
        pool.fork(pool.free[0])


def test_write_tokens_scatters_one_token_per_row(cfg):
    pool = _pool(cfg)
    pages = [pool.alloc() for _ in range(3)]
    dense = init_cache(cfg, 3, MAX_SEQ, device="cpu")
    g = torch.Generator().manual_seed(5)
    for e in dense:
        e["k"].normal_(generator=g)
        e["v"].normal_(generator=g)
        e["pos"].copy_(torch.arange(MAX_SEQ, dtype=torch.int32).expand(3, -1))
    rows, slots = np.array([0, 2, 1]), np.array([3, 17, 30])
    offs = slots % PS
    pool.write_tokens(dense, rows, slots, np.array(pages), offs)
    for e, d in zip(pool.store, dense):
        for r, s, p, o in zip(rows, slots, pages, offs):
            assert torch.equal(e["k"][p, o], d["k"][r, s])
            assert int(e["pos"][p, o]) == s
        assert int((e["pos"][pages] >= 0).sum()) == 3   # nothing else written


def test_paged_layout_config_checks(cfg):
    with pytest.raises(ValueError, match="kv_layout"):
        ServingConfig(kv_layout="ragged")
    with pytest.raises(ValueError, match="whole number"):
        ServingConfig(kv_layout="paged", page_size=12, max_seq=64)
    sc = ServingConfig(kv_layout="paged", page_size=8, max_batch=4, max_seq=64)
    assert sc.n_pool_pages == 6 * 8
    assert ServingConfig(kv_layout="paged", kv_pool_pages=5).n_pool_pages == 5
    local = dataclasses.replace(cfg, block_pattern=("local",), window=16)
    ok, why = paged_supported(local, MAX_SEQ, PS)
    assert not ok and "window" in why
    with pytest.raises(PageError):
        PagePool(local, n_pages=4, page_size=PS, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(PageError, match="block table shape"):
        _pool(cfg).gather(np.zeros((2, 3), np.int32))


# ---------------------------------------------------------------- prefix cache
@pytest.fixture(scope="module")
def jax_prefix():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.config import get_config as jget, reduced as jreduced
    from repro.serving.pages import PagePool as JPool
    from repro.serving.prefix_cache import PrefixCache as JPrefix
    jcfg = dataclasses.replace(jreduced(jget("mixtral-8x22b")), n_layers=2)
    return lambda n_pages: JPrefix(JPool(jcfg, n_pages=n_pages, page_size=PS,
                                         max_seq=MAX_SEQ, dtype=jnp.float32))


def _prefix_script(seed=0):
    """A fixed sequence of (op, prompt) over prompts that share prefixes
    of 0, 1, 2 and 3 pages."""
    rng = np.random.RandomState(seed)
    base = rng.randint(2, 50, size=40).tolist()
    prompts = [base[:24] + rng.randint(2, 50, size=5).tolist() for _ in range(3)]
    prompts += [base[:8] + rng.randint(2, 50, size=12).tolist(),
                rng.randint(2, 50, size=17).tolist(), base[:16], base[:32]]
    ops = []
    for i in rng.permutation(30) % len(prompts):
        ops.append(("admit", prompts[i]))
        if rng.rand() < 0.3:
            ops.append(("evict", int(rng.randint(1, 4))))
    return ops


def _run_prefix_script(cache, pool, ops):
    """Admit prompts the way the engine does (lookup, alloc the rest,
    insert, then drop the request's references), evict now and then;
    returns every result."""
    out = []
    for op, arg in ops:
        if op == "evict":
            out.append(("evict", cache.evict(arg)))
            continue
        n, shared = cache.lookup(arg)
        needed = n_pages_for(len(arg), PS) - len(shared)
        if pool.available < needed:
            cache.evict(needed - pool.available)
        if pool.available < needed:
            for p in shared:
                pool.release(p)
            out.append(("full", n))
            continue
        fresh = [pool.alloc() for _ in range(needed)]
        table = list(shared) + fresh
        inserted = cache.insert(arg, table)
        for p in table:
            pool.release(p)
        out.append(("admit", n, tuple(shared), tuple(fresh), inserted))
    return out


@pytest.mark.parametrize("n_pages", [6, 40])
def test_prefix_cache_matches_jax(cfg, jax_prefix, n_pages):
    ops = _prefix_script()
    jcache = jax_prefix(n_pages)
    want = _run_prefix_script(jcache, jcache.pool, ops)
    pool = _pool(cfg, n_pages=n_pages)
    cache = PrefixCache(pool)
    got = _run_prefix_script(cache, pool, ops)
    assert got == want
    assert cache.stats() == jcache.stats()
    assert len(cache) == len(jcache)
    np.testing.assert_array_equal(pool.refcount, jcache.pool.refcount)
    assert list(pool.free) == list(jcache.pool.free)
    st = cache.stats()
    assert st["hits"] > 0 and st["misses"] > 0
    assert st["evictions"] > 0


def test_prefix_lookup_pins_and_leaves_the_last_token(cfg):
    pool = _pool(cfg)
    cache = PrefixCache(pool)
    prompt = list(range(2, 2 + 2 * PS))               # exactly two pages
    pages = [pool.alloc() for _ in range(2)]
    assert cache.insert(prompt, pages) == 2
    n, hit = cache.lookup(prompt)
    assert n == PS and hit == pages[:1]               # capped: last token recomputed
    assert pool.refcount[pages[0]] == 3               # alloc + tree + pin
    for p in pages:
        pool.release(p)
    pool.release(hit[0])
    assert cache.evict(5) == 2 and pool.used == 0
