"""Training on a (data, model) process grid (``make_train_step(mesh=...)``,
``models.parallel``, ``launch.sharding``) against the JAX step, on the
CPU: gloo ranks from ``dist_smoke.run_ranks`` on the (1, 2), (2, 2) and
(1, 4) grids, each rank holding its blocks of the JAX ``init_params``
draw under the "ep" rules (``bridge.shards_from_jax``).

The JAX reference (``tests/_torch_grid_ref.py``, a child with 4 forced
host devices) is the JAX launcher's step on the same grid (params
placed by ``shlib.param_specs``, GSPMD sharding the step) for mixtral and
qwen2-moe, and the step on one device for the rest.  The configs,
reduced:
  * mixtral: one kv head, split by the rule's columns on m = 2, so the
    ranks gather it; 4 experts, EP;
  * qwen2-moe: shared experts, ``shared_gate``; with 6 experts on m = 4
    the rules fall back to TP over d_ff;
  * granite: dense GQA, one kv head;
  * gemma2: local layers, both softcaps, tied embeddings (two kv heads:
    split on m = 2, gathered on m = 4).
Remat none and full, dots on one case; a remat case is held against the
JAX step without remat, which computes the same values.  Held:
  * the 3 steps' losses and aux within 1e-5 relative;
  * the entries dropped in each step equal to the JAX step's;
  * step 0's gradients, gathered, within 1e-5 of each leaf's max |g|;
  * the params after 3 steps by ``test_torch_training.py``'s mixtral
    rule (at most 1e-4 of a leaf's elements past 1e-4 of its max |p|,
    none past the lr summed over the steps);
  * the gradient of every leaf the rules leave whole over "model" equal
    on every model rank;
  * the grid's checkpoint restores into one process, and a
    one-process checkpoint into each rank's blocks (in the ranks);
  * recurrentgemma (``rglru``, once refused) on m = 2: the steps' losses
    on the rank's blocks equal one process's (the four other kinds
    against JAX: ``test_torch_model_axis_kinds.py``);
  * (in the ranks) ``forward_train``'s gathered vocabulary-parallel
    logits within 1e-5 of one process's.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import grid_config
from repro_torch.bridge import params_from_jax
from repro_torch.launch.dist_smoke import run_ranks
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.optimizer import init_opt_state, named_leaves

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
REF = os.path.join(HERE, "_torch_grid_ref.py")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
STEPS, BATCH, SEQ = 3, 4, 17
QWEN6 = {"n_experts": 6}
# (case, arch, MoE overrides, grid, remat, JAX reference: "grid" for the
#  JAX step on the same grid, None for one device)
CASES = [
    ("mixtral-1x2", "mixtral-8x22b", None, (1, 2), "none", "grid"),
    ("mixtral-1x2-full", "mixtral-8x22b", None, (1, 2), "full", "grid"),
    ("qwen2-moe-1x2-full", "qwen2-moe-a2.7b", None, (1, 2), "full", None),
    ("granite-1x2", "granite-3-8b", None, (1, 2), "none", None),
    ("gemma2-1x2", "gemma2-27b", None, (1, 2), "none", None),
    ("mixtral-2x2", "mixtral-8x22b", None, (2, 2), "none", "grid"),
    ("mixtral-2x2-dots", "mixtral-8x22b", None, (2, 2), "dots", "grid"),
    ("qwen2-moe-2x2", "qwen2-moe-a2.7b", None, (2, 2), "none", "grid"),
    ("gemma2-2x2-full", "gemma2-27b", None, (2, 2), "full", None),
    ("qwen2-moe-6e-1x4", "qwen2-moe-a2.7b", QWEN6, (1, 4), "none", "grid"),
    ("mixtral-1x4", "mixtral-8x22b", None, (1, 4), "none", None),
    ("granite-1x4-full", "granite-3-8b", None, (1, 4), "full", None),
    ("gemma2-1x4", "gemma2-27b", None, (1, 4), "none", None),
]
GRIDS = [(1, 2), (2, 2), (1, 4)]


def _ref_key(arch, moe, grid, ref):
    return (arch, tuple(sorted((moe or {}).items())), grid if ref == "grid" else None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX reference, [each rank's results])}, and the rglru
    case's losses (grid and one process, per rank) under "rglru"."""
    jax = pytest.importorskip("jax")
    import dataclasses

    from repro import config as jconfig
    from repro.models import transformer as jtf

    def jax_config(case):            # _torch_grid_ref.config, in this process
        jcfg = jconfig.reduced(jconfig.get_config(case["arch"]))
        if case["moe"]:
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, **case["moe"]))
        return jcfg

    tmp = tmp_path_factory.mktemp("grid")
    refs, inputs = {}, {g: [] for g in GRIDS}
    for name, arch, moe, grid, remat, ref in CASES:
        case = {"name": name, "arch": arch, "moe": moe, "grid": grid,
                "remat": remat, "opt": OPT}
        cfg = grid_config(case)
        key = _ref_key(arch, moe, grid, ref)
        if key not in refs:
            pj = jax.tree.map(np.asarray, jtf.init_params(jax_config(case),
                                                          jax.random.PRNGKey(0)))
            toks = np.random.RandomState(3).randint(
                0, cfg.vocab, (STEPS, BATCH, SEQ)).astype(np.int32)
            refs[key] = {"key": key, "arch": arch, "moe": moe, "grid": key[2],
                         "opt": OPT, "tokens": toks, "params": pj}
        # a one-process checkpoint of the initial params, for the ranks
        ck = str(tmp / f"one-{name}")
        p0 = params_from_jax(refs[key]["params"], cfg, device="cpu")
        tckpt.save(ck, 0, p0, init_opt_state(p0))
        inputs[grid].append(dict(case, tokens=refs[key]["tokens"],
                                 params=refs[key]["params"], ckpt=ck))
    inputs[(1, 2)].append({"name": "rglru", "arch": "recurrentgemma-2b",
                           "grid": (1, 2), "opt": OPT, "against_one": True,
                           "tokens": np.random.RandomState(4).randint(
                               0, 512, (STEPS, BATCH, SEQ)).astype(np.int32)})
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
            out = run_ranks([WORKER, "grid", str(d / "in.pkl"), str(d)], n,
                            timeout=150, coordinator=f"file://{d}/store")
            for rank, (rc, text) in enumerate(out):
                assert rc == 0, f"{grid} rank {rank} exit {rc}:\n{text[-3000:]}"
            ranks = []
            for r in range(n):
                with open(d / f"grid{r}.pkl", "rb") as fh:
                    ranks.append(pickle.load(fh))
            for case in inputs[grid]:
                got[case["name"]] = ([r[case["name"]] for r in ranks],
                                     str(d / f"ck-{case['name']}"))
        text, _ = jax_child.communicate(timeout=300)
    finally:
        jax_child.kill()
    assert jax_child.returncode == 0, text[-3000:]
    with open(tmp / "want.pkl", "rb") as fh:
        want = pickle.load(fh)
    out = {"rglru": got["rglru"][0]}
    for name, arch, moe, grid, remat, ref in CASES:
        out[name] = (want[_ref_key(arch, moe, grid, ref)], *got[name])
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_grid_training_matches_the_jax_step(runs, case):
    want, ranks, ck = runs[case]
    spec = next(c for c in CASES if c[0] == case)
    cfg = grid_config({"arch": spec[1], "moe": spec[2]})
    tree = lambda t: dict(named_leaves(params_from_jax(t, cfg, device="cpu")))
    for r in ranks:
        got = r["metrics"]
        np.testing.assert_allclose([m["loss"] for m in got], want["loss"], rtol=1e-5)
        np.testing.assert_allclose([m["aux"] for m in got], want["aux"], rtol=1e-5,
                                   atol=1e-9)
        if want["drops"] is None:
            assert all(m["dropped"] == 0 for m in got)
        else:
            assert [m["dropped"] for m in got] == want["drops"], (got, want["drops"])
            assert sum(want["drops"]) > 0
    m = spec[3][1]
    for r, res in enumerate(ranks):
        head = ranks[r - r % m]["whole_grads"]
        assert res["whole_grads"].keys() == head.keys()
        for k, g in res["whole_grads"].items():
            assert np.array_equal(g, head[k]), (case, r, k)
    g_want, g_got = tree(want["grads"]), ranks[0]["grads"]
    assert g_got.keys() == g_want.keys()
    for k, g in g_got.items():
        w = g_want[k].numpy()
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-5 * scale, f"{k}: {err:.3e} > 1e-5 x {scale:.3e}"
    lr_sum = sum(float(v) for v in _lrs())
    p_want = tree(want["params"])
    for k, p in ranks[0]["params"].items():
        w = p_want[k].numpy()
        err = np.abs(p - w)
        off = err > 1e-4 * np.abs(w).max()
        assert off.sum() <= 1e-4 * err.size, (k, int(off.sum()), err.size)
        assert err.max() < lr_sum, (k, float(err.max()))
    # the grid's checkpoint, in one process: the gathered params
    tmpl = params_from_jax(want["params"], cfg, device="cpu")
    back, opt, step = tckpt.restore(ck, tmpl, init_opt_state(tmpl))
    assert step == STEPS and int(opt.step) == STEPS
    for k, t in named_leaves(back):
        assert np.array_equal(t.numpy(), ranks[0]["params"][k]), k


def _lrs():
    from repro_torch.training.optimizer import AdamWConfig, cosine_lr
    return [cosine_lr(AdamWConfig(**OPT), s + 1) for s in range(STEPS)]


def test_rglru_on_a_model_axis_raises(runs):
    """Once a refusal: RG-LRU now trains on a model axis of 2, each rank's
    loss in every step that of one process's steps."""
    for r in runs["rglru"]:
        one, grid = r["losses"]
        assert len(one) == STEPS
        np.testing.assert_allclose(grid, one, rtol=1e-5)
