"""Serving on a (data, model) process grid (``prefill`` and greedy
``decode_step``s under ``models.parallel.ModelParallel``, every rank on
its blocks of the params and of the KV cache) against the JAX passes
sharded on the same grid, on the CPU.

The ranks are gloo processes from ``dist_smoke.run_ranks``
(``tests/_torch_dist_worker.py serve``) on the (1, 2), (2, 2) and (1, 4)
grids, each holding its blocks of the JAX ``init_params`` draw under the
"ep" rules (``bridge.shards_from_jax``) and its rows of the prompts.  The
JAX reference (``tests/_torch_serve_ref.py``, a child with 4 forced host
devices) is the JAX dry run's layout: params by ``shlib.param_specs``,
tokens by ``shlib.input_spec``, the cache by ``shlib.cache_specs``.  The
configs, reduced:
  * mixtral: one kv head, so the ring's slots go over "model" and the
    ranks merge their partial softmax rows (also with the experts as
    m2n shards over "model", the path of the card's kernels);
  * qwen2-moe: four kv heads, over "model" on both grids (the JAX mini
    dry run's arch), shared experts;
  * gemma2 on (1, 4): two kv heads do not divide 4, so the slots split;
    a local layer whose 16-slot ring wraps at prefill, both softcaps.
Held: each pass's logits within 5e-4, the greedy tokens exact, each
rank's cache blocks equal to the JAX cache's blocks under
``cache_entry_specs`` (values within 5e-4, positions exact), the gathered
cache equal to the whole one; recurrentgemma (``rglru``, once refused)
on (1, 2) gives one process's logits and tokens (the four other kinds
against JAX: ``test_torch_model_axis_kinds_decode.py``).  Without
ranks: ``decode_attention``'s partial branch (plain) merged over 2-4
blocks of slots by ``ModelParallel.merge_partials`` equals the whole
ring, and a ``migrate_kv`` without a transport is one "kv" hop of the
process-wide default transport.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import grid_config
from repro_torch.bridge import cache_from_jax
from repro_torch.launch import sharding as sh
from repro_torch.launch.dist_smoke import run_ranks
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.models import transformer as tf
from repro_torch.models.attention import decode_attention, decode_attention_partial
from repro_torch.models.parallel import ModelParallel

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
REF = os.path.join(HERE, "_torch_serve_ref.py")
BATCH, STEPS, MAX_SEQ = 4, 4, 32
# (case, arch, grid, prompt length, m2n experts over "model")
CASES = [
    ("mixtral-1x2", "mixtral-8x22b", (1, 2), 6, False),
    ("mixtral-1x2-m2n", "mixtral-8x22b", (1, 2), 6, True),
    ("qwen2-moe-1x2", "qwen2-moe-a2.7b", (1, 2), 6, False),
    ("mixtral-2x2", "mixtral-8x22b", (2, 2), 6, False),
    ("qwen2-moe-2x2", "qwen2-moe-a2.7b", (2, 2), 6, False),
    ("gemma2-1x4", "gemma2-27b", (1, 4), 20, False),
]
GRIDS = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX reference, [each rank's results])} and the rglru
    case's passes (grid and one process, per rank) under "rglru"."""
    jax = pytest.importorskip("jax")
    from repro import config as jconfig
    from repro.models import transformer as jtf

    tmp = tmp_path_factory.mktemp("serve")
    refs, inputs = {}, {g: [] for g in GRIDS}
    for name, arch, grid, T, m2n in CASES:
        key = (arch, grid, T)
        if key not in refs:
            jcfg = jconfig.reduced(jconfig.get_config(arch))
            pj = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
            toks = np.random.RandomState(5).randint(
                0, jcfg.vocab, (BATCH, T)).astype(np.int32)
            refs[key] = {"key": key, "arch": arch, "grid": grid, "tokens": toks,
                         "params": pj, "steps": STEPS, "max_seq": MAX_SEQ}
        inputs[grid].append({"name": name, "arch": arch, "grid": grid, "m2n": m2n,
                             "tokens": refs[key]["tokens"], "steps": STEPS,
                             "max_seq": MAX_SEQ, "params": refs[key]["params"]})
    inputs[(1, 2)].append({"name": "rglru", "arch": "recurrentgemma-2b",
                           "grid": (1, 2), "against_one": True, "steps": STEPS,
                           "max_seq": MAX_SEQ,
                           "tokens": np.random.RandomState(6).randint(
                               0, 512, (BATCH, 20)).astype(np.int32)})
    with open(tmp / "refs.pkl", "wb") as fh:
        pickle.dump(list(refs.values()), fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    env.pop("XLA_FLAGS", None)
    jax_child = subprocess.Popen([sys.executable, REF, str(tmp / "refs.pkl"),
                                  str(tmp / "want.pkl")], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
    got = {}
    try:
        for grid in GRIDS:
            d = tmp / f"{grid[0]}x{grid[1]}"
            d.mkdir()
            with open(d / "in.pkl", "wb") as fh:
                pickle.dump(inputs[grid], fh)
            n = grid[0] * grid[1]
            out = run_ranks([WORKER, "serve", str(d / "in.pkl"), str(d)], n,
                            timeout=150, coordinator=f"file://{d}/store")
            for rank, (rc, text) in enumerate(out):
                assert rc == 0, f"{grid} rank {rank} exit {rc}:\n{text[-3000:]}"
            ranks = []
            for r in range(n):
                with open(d / f"serve{r}.pkl", "rb") as fh:
                    ranks.append(pickle.load(fh))
            for case in inputs[grid]:
                got[case["name"]] = [r[case["name"]] for r in ranks]
        text, _ = jax_child.communicate(timeout=300)
    finally:
        jax_child.kill()
    assert jax_child.returncode == 0, text[-3000:]
    with open(tmp / "want.pkl", "rb") as fh:
        want = pickle.load(fh)
    out = {"rglru": got["rglru"]}
    for name, arch, grid, T, _ in CASES:
        out[name] = (want[(arch, grid, T)], got[name])
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_serving_on_a_grid_matches_jax(runs, case):
    want, ranks = runs[case]
    for r, res in enumerate(ranks):
        lo, hi = res["rows"]
        assert len(res["logits"]) == len(want["logits"]) == STEPS + 1
        for s, (g, w) in enumerate(zip(res["logits"], want["logits"])):
            np.testing.assert_allclose(g, w[lo:hi], rtol=5e-4, atol=5e-4,
                                       err_msg=f"{case} rank {r} pass {s}")
        for s, (g, w) in enumerate(zip(res["tokens"], want["tokens"])):
            assert np.array_equal(g, w[lo:hi]), (case, r, s, g, w[lo:hi])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_cache_blocks_are_the_jax_blocks(runs, case):
    """Each rank's blocks are the JAX cache's blocks under
    ``cache_entry_specs`` at its coordinate; rank 0's gathered cache
    (``sharding.gather_cache``) is the whole JAX cache."""
    want, ranks = runs[case]
    spec = next(c for c in CASES if c[0] == case)
    cfg = grid_config({"arch": spec[1]})
    full = cache_from_jax(want["cache"], cfg, device="cpu")
    grid = spec[2]
    specs = sh.cache_specs(cfg, full, RecordingMesh(grid, ("data", "model")), BATCH)
    split = 0
    for r, res in enumerate(ranks):
        mesh = RecordingMesh(grid, ("data", "model"), divmod(r, grid[1]))
        blocks = sh.shard_tree(full, specs, mesh)
        assert len(blocks) == len(res["cache"]) == len(cfg.layer_kinds)
        for layer, (b, g) in enumerate(zip(blocks, res["cache"])):
            assert b.keys() == g.keys()
            for k in b:
                assert tuple(b[k].shape) == g[k].shape, (case, r, layer, k)
                split += b[k].numel() < full[layer][k].numel()
                if k == "pos":
                    assert np.array_equal(g[k], b[k].numpy()), (case, r, layer)
                else:
                    np.testing.assert_allclose(g[k], b[k].numpy(), rtol=5e-4,
                                               atol=5e-4)
    assert split > 0
    for layer, (g, w) in enumerate(zip(ranks[0]["gathered"], full)):
        assert np.array_equal(g["pos"], w["pos"].numpy()), (case, layer)
        for k in ("k", "v"):
            np.testing.assert_allclose(g[k], w[k].numpy(), rtol=5e-4, atol=5e-4)


def test_rglru_refuses_prefill_and_decode_on_a_model_axis(runs):
    """Once a refusal: RG-LRU now serves on a model axis of 2, each rank's
    prefill and decode logits within 5e-4 of one process's and its greedy
    tokens equal (a 20-token prompt wraps the 16-slot local ring)."""
    for res in runs["rglru"]:
        (l1, t1), (lg, tg) = res["one"], res["grid"]
        assert len(lg) == len(l1) == STEPS + 1
        for g, w in zip(lg, l1):
            np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4)
        for g, w in zip(tg, t1):
            assert np.array_equal(g, w)


class _Stacked:
    """A stand-in mesh holding every rank's tensor on a leading dim: its
    ``all_reduce`` reduces over that dim and hands each rank the result,
    so ``merge_partials`` runs its own code for all ranks at once."""

    def __init__(self, n):
        self.n = n

    def size(self, axes):
        return self.n

    def index(self, axes):
        return 0

    def all_reduce(self, t, axes, op="sum"):
        r = t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)
        return t.copy_(r.expand_as(t))


# (blocks, window, softcap, a block with no valid slot)
MERGES = [(2, 0, 0.0, False), (3, 0, 0.0, False), (4, 0, 0.0, True),
          (2, 5, 50.0, True), (4, 0, 30.0, False)]


@pytest.mark.parametrize("n,window,cap,empty", MERGES)
def test_partial_rows_merged_over_slot_blocks_equal_the_whole_ring(n, window, cap,
                                                                   empty):
    rng = np.random.RandomState(n + window)
    B, H, Hkv, hd, W = 3, 6, 2, 16, 24
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, W, Hkv, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, W, Hkv, hd).astype(np.float32))
    pos = torch.tensor([20, 9, 30], dtype=torch.int32)
    cpos = torch.from_numpy(rng.randint(-1, 31, (B, W))).to(torch.int32)
    # row 1: keys only from slot 10 on, positions 0..13 (its valid slots
    # lie in the last blocks)
    cpos[1] = torch.arange(W, dtype=torch.int32) - 10
    cpos[1, :10] = -1
    if empty:
        cpos[:, :W // n] = -1       # every row: block 0 holds no valid slot
    whole = decode_attention(q, k, v, cpos, pos, window=window, attn_softcap=cap)
    wl = W // n
    outs, lses = zip(*(decode_attention_partial(
        q, k[:, i * wl:(i + 1) * wl], v[:, i * wl:(i + 1) * wl],
        cpos[:, i * wl:(i + 1) * wl], pos, window=window, attn_softcap=cap)
        for i in range(n)))
    if empty:
        assert torch.isneginf(lses[0]).all() and float(outs[0].abs().max()) == 0
    mp = ModelParallel(_Stacked(n))
    merged = mp.merge_partials(torch.stack(outs), torch.stack(lses))
    for i in range(n):
        torch.testing.assert_close(merged[i], whole, rtol=1e-5, atol=1e-5)


def test_partial_row_with_no_valid_slot_is_zero_with_lse_minus_inf():
    B, H, Hkv, hd, W = 2, 4, 2, 8, 8
    q = torch.randn(B, H, hd)
    k, v = torch.randn(B, W, Hkv, hd), torch.randn(B, W, Hkv, hd)
    cpos = torch.full((B, W), -1, dtype=torch.int32)
    cpos[1, :3] = torch.tensor([0, 1, 2], dtype=torch.int32)
    out, lse = decode_attention_partial(q, k, v, cpos, torch.tensor([4, 4],
                                                                    dtype=torch.int32))
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1]).all()
    assert float(out[0].abs().max()) == 0 and not torch.isnan(out).any()
    merged = ModelParallel(_Stacked(2)).merge_partials(torch.stack([out, out]),
                                                       torch.stack([lse, lse]))
    assert float(merged[:, 0].abs().max()) == 0
    torch.testing.assert_close(merged[0, 1], out[1], rtol=1e-6, atol=1e-6)


def test_migrate_kv_without_a_transport_is_a_hop_of_the_default():
    """As the JAX package's ``test_migrate_kv_default_transport``: the
    process-wide default transport accounts the hop."""
    from repro_torch.config import get_config, reduced
    from repro_torch.core import transport as transport_lib
    from repro_torch.serving.kvcache import migrate_kv
    cfg = reduced(get_config("mixtral-8x22b"))
    params = tf.init_params(cfg, 0, device="cpu")
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    with torch.no_grad():
        _, req_kv = tf.prefill(params, cfg, torch.tensor([[3, 4, 5]]), max_seq=16)
    before = transport_lib.default_transport()._stats["kv"]["hops"]
    migrate_kv(cache, req_kv, 0)
    assert transport_lib.default_transport() is transport_lib.default_transport()
    assert transport_lib.default_transport()._stats["kv"]["hops"] == before + 1
    assert torch.equal(cache[0]["k"][0], req_kv[0]["k"][0])
