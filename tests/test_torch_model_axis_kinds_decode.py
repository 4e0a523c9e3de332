"""Serving on a (data, model) process grid for the layer kinds besides
``attn`` / ``local`` and for query heads that do not split over "model":
``prefill`` and greedy ``decode_step``s under ``ModelParallel``, every
rank on its blocks of the params and of the cache, against the JAX
passes sharded on the same grid, on the CPU.

The pattern of ``test_torch_model_axis_decode.py``: gloo ranks
(``tests/_torch_dist_worker.py serve``) on the (1, 2), (2, 2), (1, 4)
and (1, 3) grids, each holding its blocks of the JAX ``init_params``
draw under the "ep" rules and its rows of the prompts and of the JAX
stub inputs; the JAX reference (``tests/_torch_serve_ref.py``, 4 forced
host devices) places params, tokens and cache as the JAX dry run does.
llama-vision's cross gates are opened to 0.5.  The configs, reduced,
with a 48-slot cache (it divides 2, 3 and 4 ranks):
  * mamba2: the ``ssm`` state by heads, the ``conv`` window by blocks of
    its 544 channels;
  * recurrentgemma: ``h`` / ``conv`` by channels; the local ring (1 kv
    head, 16 slots, wrapped by a 20-token prompt) by slots, 4 ways on
    (1, 4), with every head gathered and the partial rows merged;
  * whisper: the encoder tensor-parallel, the self ring and the cross
    K / V by kv heads;
  * llama-vision: the cross source (1 kv head) over slots on (1, 2) and
    (2, 2) (16 patches: partial cross attention merged across ranks),
    whole on (1, 3) (16 does not divide 3);
  * minitron with 6 query heads on (1, 4): 1.5 heads a rank.
Held: each pass's logits within 5e-4, the greedy tokens exact, over the
prefill and 4 decode steps; each rank's cache blocks (``h``, ``conv``,
``ssm``, ``k``, ``v``, ``k_src``, ``v_src``, ``pos``) equal to the JAX
cache's blocks under ``cache_entry_specs`` (values within 5e-4,
positions exact) and the cache gathered on rank 0 equal to the whole
one.  Without ranks: a cross source merged over 2-4 blocks of slots by
``merge_partials`` equals ``cross_attention`` over the whole source.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import grid_config
from _torch_family import open_gates
from repro_torch.bridge import cache_from_jax
from repro_torch.launch import sharding as sh
from repro_torch.launch.dist_smoke import run_ranks
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.models.attention import cross_attention, cross_attention_partial
from repro_torch.models.parallel import ModelParallel
from test_torch_model_axis_decode import _Stacked

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
REF = os.path.join(HERE, "_torch_serve_ref.py")
BATCH, STEPS, MAX_SEQ = 4, 4, 48
# (case, arch, query heads (None: the reduced config's 4), grid, prompt length)
CASES = [
    ("mamba2-1x2", "mamba2-1.3b", None, (1, 2), 6),
    ("mamba2-2x2", "mamba2-1.3b", None, (2, 2), 6),
    ("recurrentgemma-1x2", "recurrentgemma-2b", None, (1, 2), 20),
    ("recurrentgemma-2x2", "recurrentgemma-2b", None, (2, 2), 20),
    ("recurrentgemma-1x4", "recurrentgemma-2b", None, (1, 4), 20),
    ("whisper-1x2", "whisper-large-v3", None, (1, 2), 6),
    ("whisper-2x2", "whisper-large-v3", None, (2, 2), 6),
    ("llama-vision-1x2", "llama-3.2-vision-90b", None, (1, 2), 6),
    ("llama-vision-2x2", "llama-3.2-vision-90b", None, (2, 2), 6),
    ("llama-vision-1x3", "llama-3.2-vision-90b", None, (1, 3), 6),
    ("minitron-6h-1x4", "minitron-4b", 6, (1, 4), 6),
]
GRIDS = [(1, 2), (2, 2), (1, 4), (1, 3)]


def _config(case):
    _, arch, n_heads, *_ = next(c for c in CASES if c[0] == case)
    return grid_config({"arch": arch, "n_heads": n_heads})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX reference, [each rank's results])}."""
    jax = pytest.importorskip("jax")
    from repro import config as jconfig
    from repro.models import stubs as jstubs
    from repro.models import transformer as jtf

    tmp = tmp_path_factory.mktemp("kinds_serve")
    refs, inputs = [], {g: [] for g in GRIDS}
    for name, arch, n_heads, grid, T in CASES:
        jcfg = jconfig.reduced(jconfig.get_config(arch),
                               **({"n_heads": n_heads} if n_heads else {}))
        pj = open_gates(jax.tree.map(np.asarray,
                                     jtf.init_params(jcfg, jax.random.PRNGKey(0))))
        toks = np.random.RandomState(5).randint(0, jcfg.vocab,
                                                (BATCH, T)).astype(np.int32)
        extras = {k: np.asarray(v) for k, v in jstubs.extra_inputs(jcfg, BATCH).items()}
        case = {"name": name, "arch": arch, "n_heads": n_heads, "grid": grid,
                "tokens": toks, "steps": STEPS, "max_seq": MAX_SEQ, "params": pj,
                "extras": extras}
        refs.append(dict(case, key=name))
        inputs[grid].append(case)
    with open(tmp / "refs.pkl", "wb") as fh:
        pickle.dump(refs, fh)
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
                            timeout=180, coordinator=f"file://{d}/store")
            for rank, (rc, text) in enumerate(out):
                assert rc == 0, f"{grid} rank {rank} exit {rc}:\n{text[-3000:]}"
            ranks = []
            for r in range(n):
                with open(d / f"serve{r}.pkl", "rb") as fh:
                    ranks.append(pickle.load(fh))
            for case in inputs[grid]:
                got[case["name"]] = [r[case["name"]] for r in ranks]
        text, _ = jax_child.communicate(timeout=400)
    finally:
        jax_child.kill()
    assert jax_child.returncode == 0, text[-3000:]
    with open(tmp / "want.pkl", "rb") as fh:
        want = pickle.load(fh)
    return {name: (want[name], got[name]) for name, *_ in CASES}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_serving_every_kind_on_a_grid_matches_jax(runs, case):
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
def test_every_cache_block_is_the_jax_block(runs, case):
    """Each rank's blocks of every entry are the JAX cache's blocks under
    ``cache_entry_specs`` at its coordinate; rank 0's gathered cache is
    the whole JAX cache."""
    want, ranks = runs[case]
    cfg = _config(case)
    grid = next(c for c in CASES if c[0] == case)[3]
    full = cache_from_jax(want["cache"], cfg, device="cpu")
    specs = sh.cache_specs(cfg, full, RecordingMesh(grid, ("data", "model")), BATCH)
    split = set()
    for r, res in enumerate(ranks):
        mesh = RecordingMesh(grid, ("data", "model"), divmod(r, grid[1]))
        blocks = sh.shard_tree(full, specs, mesh)
        assert len(blocks) == len(res["cache"]) == len(cfg.layer_kinds)
        for layer, (b, g) in enumerate(zip(blocks, res["cache"])):
            assert b.keys() == g.keys()
            for k in b:
                assert tuple(b[k].shape) == g[k].shape, (case, r, layer, k)
                if b[k].numel() < full[layer][k].numel():
                    split.add(k)
                if k == "pos":
                    assert np.array_equal(g[k], b[k].numpy()), (case, r, layer)
                else:
                    np.testing.assert_allclose(g[k], b[k].numpy(), rtol=5e-4,
                                               atol=5e-4, err_msg=f"{case} {r} {k}")
    kinds = set(cfg.layer_kinds)
    if "ssd" in kinds:
        assert {"ssm", "conv"} <= split
    if "rglru" in kinds:
        assert {"h", "conv", "k", "v", "pos"} <= split
    if case == "whisper-1x2":            # kv heads: self ring and source
        assert {"k", "v", "k_src", "v_src"} <= split and "pos" not in split
    if case == "llama-vision-1x2":       # the source over slots
        assert {"k_src", "v_src", "pos"} <= split
    if case == "llama-vision-1x3":       # 16 patches on 3 ranks: whole
        assert not {"k_src", "v_src"} & split
    for layer, (g, w) in enumerate(zip(ranks[0]["gathered"], full)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k].numpy(), rtol=5e-4, atol=5e-4,
                                       err_msg=f"{case} gathered {layer} {k}")


@pytest.mark.parametrize("n", [2, 3, 4])
def test_cross_source_merged_over_slot_blocks_equals_the_whole(n):
    """``cross_attention_partial`` over each of n blocks of a 24-slot
    source, merged by ``merge_partials``, equals ``cross_attention`` over
    all of it (GQA: 6 query heads on 2 kv heads)."""
    rng = np.random.RandomState(n)
    B, Sq, H, Hkv, hd, S = 3, 2, 6, 2, 16, 24
    q = torch.from_numpy(rng.randn(B, Sq, H, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, S, Hkv, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, S, Hkv, hd).astype(np.float32))
    whole = cross_attention(q, k, v)
    sl = S // n
    outs, lses = zip(*(cross_attention_partial(q, k[:, i * sl:(i + 1) * sl],
                                               v[:, i * sl:(i + 1) * sl])
                       for i in range(n)))
    merged = ModelParallel(_Stacked(n)).merge_partials(torch.stack(outs),
                                                       torch.stack(lses))
    for i in range(n):
        torch.testing.assert_close(merged[i], whole, rtol=1e-5, atol=1e-5)
