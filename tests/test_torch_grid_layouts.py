"""The JAX dry run's other training layouts on a (2, 2) ("data", "model")
grid of gloo CPU ranks (``make_train_step(mesh=..., expert_mode=, fsdp=,
zero=, moe_impl=, seq_parallel=)``, ``launch.sharding.Layout``,
``models.parallel``), against the JAX step built as the JAX dry run
builds a train record on the same grid of forced host devices
(``tests/_torch_grid_ref.py``: params placed by ``param_specs``, moments
by ``zero_extend``, ``ACT_SPEC`` set, ``use_m2n`` entered).

The layouts, on reduced qwen2-moe (shared experts), mixtral (one kv
head) and granite (dense), f32, 3 steps of 4 x 16 tokens (15 in one
sequence-parallel case, which pads the sequence's blocks as
``with_sharding_constraint`` does):
  * fsdp on 2 layers: JAX splits the block-period leaves on their
    stacked block dim, so each is held whole by one data rank and sent
    from it (``parallel.from_owner``); fsdp with ZeRO-1 there is JAX's
    ``DuplicateSpecError``, and the port's with JAX's words;
  * fsdp + ZeRO-1 and ep2d + ZeRO-1 on one layer of a 5-expert qwen2-moe
    (the experts fall back to TP over d_ff, so ``zero_extend`` finds no
    second dim), fsdp + ZeRO-1 on 3 granite layers, ep2d on mixtral
    under remat full;
  * sequence parallelism, with ZeRO-1 (its moments on the stacked block
    dim: held by one data rank) and without, under remat full;
  * m2n and m2n2d: routing and capacity per data block, the aux
    averaged over the data ranks, 5 experts padded to 6 buckets; with
    ZeRO-1, as the JAX dry run's train records have them (on one layer
    an m2n expert shard's moments split over the data ranks; on 2 layers
    held by one of them), and without.
Held: the losses and aux within 1e-5 relative, the last step's loss
reading the params that step 1 made from the moments step 0 left (the
ZeRO-1 blocks carried across steps and the params gathered back after
each update); the entries dropped in each step equal to JAX's where the
experts route over the global batch; each rank's block of step 0's
gradients (as AdamW updates it) within 1e-5 of the leaf's max |g|; each
rank's block of the params after step 0 within AdamW's first-step bound
of JAX's (``adamw_first_step_bound``); the blocks of the final params in
the layout's shapes (their values only within the lr summed over the
steps: an AdamW step's size, so the losses hold the later steps).  A
sequence-parallel prefill's logits within 1e-5 of JAX's and of the same
prefill without the flag, the two caches within 1e-5.  And the new
collectives (``ProcessMesh.all_gather`` / ``reduce_scatter``) and their
autograd pairs on 4 gloo ranks against numpy.
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
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.launch.sharding import Layout
from repro_torch.training.optimizer import AdamWConfig, cosine_lr, named_leaves
from test_torch_model_axis_launch import adamw_first_step_bound

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
REF = os.path.join(HERE, "_torch_grid_ref.py")
GRID = (2, 2)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
STEPS, BATCH, SEQ = 3, 4, 16
FSDP, ZERO = dict(fsdp=True), dict(zero=True)
E5 = {"n_experts": 5}
# (case, arch, layers, MoE overrides, layout, remat, sequence, prefill)
CASES = [
    ("qwen2-fsdp", "qwen2-moe-a2.7b", 2, None, FSDP, "none", SEQ, False),
    ("qwen2-fsdp-zero", "qwen2-moe-a2.7b", 2, None, dict(FSDP, **ZERO), "none", SEQ,
     False),
    ("qwen2-5e-fsdp-zero", "qwen2-moe-a2.7b", 1, E5, dict(FSDP, **ZERO), "none", SEQ,
     False),
    ("qwen2-5e-ep2d-zero", "qwen2-moe-a2.7b", 1, E5, dict(expert_mode="ep2d", **ZERO),
     "none", SEQ, False),
    ("mixtral-ep2d-full", "mixtral-8x22b", 2, None, dict(expert_mode="ep2d"), "full",
     SEQ, False),
    ("granite-fsdp-zero", "granite-3-8b", 3, None, dict(FSDP, **ZERO), "none", SEQ,
     False),
    ("qwen2-sp-zero", "qwen2-moe-a2.7b", 2, None, dict(seq_parallel=True, **ZERO),
     "none", SEQ, False),
    ("granite-sp", "granite-3-8b", 2, None, dict(seq_parallel=True), "none", SEQ,
     True),
    ("qwen2-sp-odd", "qwen2-moe-a2.7b", 2, None, dict(seq_parallel=True), "none",
     SEQ - 1, True),
    ("mixtral-sp-full", "mixtral-8x22b", 2, None, dict(seq_parallel=True), "full",
     SEQ, True),
    ("qwen2-m2n-zero", "qwen2-moe-a2.7b", 2, None, dict(moe_impl="m2n", **ZERO), "none",
     SEQ, False),
    ("qwen2-5e-m2n-zero", "qwen2-moe-a2.7b", 1, E5, dict(moe_impl="m2n", **ZERO), "none",
     SEQ, False),
    ("qwen2-m2n2d", "qwen2-moe-a2.7b", 2, None, dict(moe_impl="m2n2d"), "none", SEQ,
     False),
    ("mixtral-m2n-full", "mixtral-8x22b", 2, None, dict(moe_impl="m2n"), "full", SEQ,
     False),
    ("qwen2-5e-m2n2d-zero", "qwen2-moe-a2.7b", 1, E5, dict(moe_impl="m2n2d", **ZERO),
     "none", SEQ,
     False),
]
SPEC = {c[0]: c for c in CASES}


def _case(name):
    _, arch, layers, moe, layout, remat, seq, pre = SPEC[name]
    return {"name": name, "arch": arch, "n_layers": layers, "moe": moe,
            "layout": layout, "remat": remat, "prefill": pre, "grid": GRID,
            "opt": OPT}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX's result, [each rank's result])}: the JAX child and the
    ranks (``_torch_dist_worker.py layouts``) run side by side."""
    jax = pytest.importorskip("jax")
    import dataclasses

    from repro import config as jconfig
    from repro.models import transformer as jtf

    tmp = tmp_path_factory.mktemp("layouts")
    refs, cases = [], []
    for k, name in enumerate(SPEC):
        case = _case(name)
        jcfg = jconfig.reduced(jconfig.get_config(case["arch"]),
                               n_layers=case["n_layers"])
        if case["moe"]:
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, **case["moe"]))
        cfg = grid_config(case)
        pj = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(k)))
        toks = np.random.RandomState(10 + k).randint(
            0, cfg.vocab, (STEPS, BATCH, SPEC[name][6] + 1)).astype(np.int32)
        refs.append(dict(case, key=name, tokens=toks, params=pj))
        cases.append(dict(case, tokens=toks, params=pj))
    with open(tmp / "refs.pkl", "wb") as fh:
        pickle.dump(refs, fh)
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    env.pop("XLA_FLAGS", None)
    child = subprocess.Popen([sys.executable, REF, str(tmp / "refs.pkl"),
                              str(tmp / "want.pkl")], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = run_ranks([WORKER, "layouts", str(tmp / "in.pkl"), str(tmp)], 4,
                        timeout=240, coordinator=f"file://{tmp}/store")
        for rank, (rc, text) in enumerate(out):
            assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"
        text, _ = child.communicate(timeout=300)
    finally:
        child.kill()
    assert child.returncode == 0, text[-3000:]
    with open(tmp / "want.pkl", "rb") as fh:
        want = pickle.load(fh)
    ranks = []
    for r in range(4):
        with open(tmp / f"layouts{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return {name: (want[name], [rk[name] for rk in ranks]) for name in SPEC}


def _layout(name, rank):
    case = _case(name)
    mesh = RecordingMesh(GRID, ("data", "model"), divmod(rank, GRID[1]))
    kw = {k: v for k, v in case["layout"].items() if k != "seq_parallel"}
    return Layout(grid_config(case), mesh, **kw)


@pytest.mark.parametrize("name", list(SPEC))
def test_layout_matches_the_jax_step(runs, name):
    want, ranks = runs[name]
    case = _case(name)
    if "refused" in want:       # JAX's own refusal, with its words
        assert want["refused"].startswith("DuplicateSpecError"), want["refused"]
        for r in ranks:
            assert r["refused"] == want["refused"], (r["refused"], want["refused"])
        return
    cfg = grid_config(case)
    tree = lambda t: dict(named_leaves(params_from_jax(t, cfg, device="cpu")))
    g_want, p0_want, p_want = tree(want["grads"]), tree(want["after0"]), \
        tree(want["params"])
    opt = AdamWConfig(**OPT)
    lr_sum = sum(float(cosine_lr(opt, s + 1)) for s in range(STEPS))
    for rank, res in enumerate(ranks):
        assert "refused" not in res, res.get("refused")
        got = res["metrics"]
        np.testing.assert_allclose([m["loss"] for m in got], want["loss"], rtol=1e-5)
        np.testing.assert_allclose([m["aux"] for m in got], want["aux"], rtol=1e-5,
                                   atol=1e-9)
        if want.get("drops") is not None:
            assert [m["dropped"] for m in got] == want["drops"], (got, want["drops"])
        lay = _layout(name, rank)
        gnorm0 = got[0]["grad_norm"]
        for lf in lay.leaves:
            k = lf.path
            g = res["grads"][k]
            gw = lay.place(k, g_want[k], "moment").numpy()
            assert g.shape == gw.shape, (name, rank, k, g.shape, gw.shape)
            scale = np.abs(g_want[k].numpy()).max()
            err = np.abs(g - gw).max() if g.size else 0.0
            assert err <= 1e-5 * scale, f"{name} rank {rank} {k}: {err:.3e} > 1e-5 x {scale:.3e}"
            p0 = lay.moment_block(lf, torch.from_numpy(res["after0"][k]))
            if p0 is not None and p0.numel():
                pw = lay.place(k, p0_want[k], "moment").numpy()
                d = np.abs(p0.numpy() - pw)
                allowed = adamw_first_step_bound(opt, gnorm0, np.abs(g - gw), pw)
                assert (d <= allowed).all(), (name, rank, k, float((d / allowed).max()))
            pf = res["final"][k]
            pfw = lay.place(k, p_want[k]).numpy()
            assert pf.shape == pfw.shape, (name, rank, k)
            if pf.size:
                assert np.abs(pf - pfw).max() < lr_sum, (name, rank, k)


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[7]])
def test_sequence_parallel_prefill(runs, name):
    """A sequence-parallel prefill of each data rank's rows: the logits
    within 1e-5 of JAX's prefill under ``ACT_SPEC`` and of the same
    prefill without the flag; the two caches (the rank's blocks) within
    1e-5."""
    want, ranks = runs[name]
    rows = BATCH // GRID[0]
    for rank, res in enumerate(ranks):
        sp, plain = res["prefill"]
        i = rank // GRID[1]
        w = want["prefill"][i * rows:(i + 1) * rows]
        scale = np.abs(w).max()
        assert np.abs(sp - w).max() <= 1e-5 * scale, (name, rank)
        assert np.abs(sp - plain).max() <= 1e-5 * scale, (name, rank)
        assert res["prefill_cache_gap"] <= 1e-5, (name, rank, res["prefill_cache_gap"])


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    out = run_ranks([WORKER, "collectives", str(tmp)], 4, timeout=120,
                    coordinator=f"file://{tmp}/store")
    for rank, (rc, text) in enumerate(out):
        assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"
    return [np.load(tmp / f"coll{r}.npz") for r in range(4)]


def _x(rank, shape=(2, 3, 4)):
    """Each rank's input of the collectives test (``_torch_dist_worker``)."""
    return np.random.RandomState(100 + rank).randn(*shape).astype(np.float32)


COLL = [("all_gather", "data", 0), ("all_gather", "model", 1),
        ("all_gather", "both", 2), ("reduce_scatter", "data", 0),
        ("reduce_scatter", "model", 2), ("reduce_scatter", "both", 1)]


@pytest.mark.parametrize("op,axes,dim", COLL, ids=[f"{o}-{a}-{d}" for o, a, d in COLL])
def test_collectives_against_numpy(collectives, op, axes, dim):
    """``ProcessMesh.all_gather`` / ``reduce_scatter`` over one axis or
    both, along a dim, against numpy on the ranks' inputs."""
    for rank, got in enumerate(collectives):
        i, j = divmod(rank, 2)
        group = {"data": [j, 2 + j], "model": [2 * i, 2 * i + 1],
                 "both": [0, 1, 2, 3]}[axes]
        idx = group.index(rank)
        if op == "all_gather":
            want = np.concatenate([_x(r) for r in group], axis=dim)
        else:
            tot = sum(np.concatenate([_x(r)] * len(group), axis=dim) for r in group)
            b = tot.shape[dim] // len(group)
            want = np.take(tot, range(idx * b, (idx + 1) * b), axis=dim)
        np.testing.assert_allclose(got[f"{op}/{axes}/{dim}"], want, rtol=1e-6, atol=1e-6)


PAIRS = ["gather_data", "from_owner", "sum_data", "seq_full", "enter_seq", "seq_block",
         "reduce_act"]


@pytest.mark.parametrize("pair", PAIRS)
def test_autograd_pairs_against_numpy(collectives, pair):
    """Each autograd collective of ``models.parallel``: forward and the
    gradient of sum(out * w) (w the rank's weights) against numpy.
    ``gather_data`` over "data" along dim 1 (its backward the sum of
    the two data ranks' gradient blocks); ``from_owner`` from data rank 1
    (the owner's gradient the sum, the other's empty); ``sum_data``;
    the sequence ops over "model" on 5 rows a sequence, padded to blocks
    of 3 (rank 1 of "model" holds 2 rows): ``seq_full``'s gradient the
    mean of the ranks' gradient blocks (a use alike on every rank counts
    once), and through ``enter_seq`` their sum (a use of each rank's
    partial)."""
    T, b = 5, 3
    for rank, got in enumerate(collectives):
        i, j = divmod(rank, 2)
        data, model = [j, 2 + j], [2 * i, 2 * i + 1]
        w = lambda r, shape: np.random.RandomState(200 + r).randn(*shape).astype(np.float32)
        out, grad = got[f"{pair}/out"], got[f"{pair}/grad"]
        if pair == "gather_data":
            x = [_x(r) for r in data]
            np.testing.assert_allclose(out, np.concatenate(x, 1), rtol=1e-6)
            g = sum(w(r, out.shape) for r in data)
            np.testing.assert_allclose(grad, g[:, 3 * i:3 * (i + 1)], rtol=1e-5, atol=1e-6)
        elif pair == "from_owner":
            np.testing.assert_allclose(out, _x(data[1]), rtol=1e-6)
            if i == 1:
                np.testing.assert_allclose(grad, sum(w(r, out.shape) for r in data),
                                           rtol=1e-5, atol=1e-6)
            else:
                assert grad.size == 0
        elif pair == "sum_data":
            np.testing.assert_allclose(out, sum(_x(r) for r in data), rtol=1e-5)
            np.testing.assert_allclose(grad, sum(w(r, out.shape) for r in data),
                                       rtol=1e-5, atol=1e-6)
        else:
            seq = lambda r: np.random.RandomState(300 + r).randn(2, T, 4).astype(np.float32)
            lo, hi = min(T, j * b), min(T, (j + 1) * b)
            if pair in ("seq_full", "enter_seq"):   # the rank's block gathered
                blocks = [seq(r)[:, min(T, k * b):min(T, (k + 1) * b)]
                          for k, r in enumerate(model)]
                np.testing.assert_allclose(out, np.concatenate(blocks, 1), rtol=1e-6)
                g = sum(w(r, out.shape) for r in model)[:, lo:hi]
                if pair == "seq_full":
                    g = g / len(model)
                np.testing.assert_allclose(grad, g, rtol=1e-5, atol=1e-6)
            elif pair == "seq_block":
                np.testing.assert_allclose(out, seq(rank)[:, lo:hi], rtol=1e-6)
                gw = np.zeros((2, T, 4), np.float32)
                for k, r in enumerate(model):
                    klo, khi = min(T, k * b), min(T, (k + 1) * b)
                    gw[:, klo:khi] = w(r, (2, khi - klo, 4))
                np.testing.assert_allclose(grad, gw, rtol=1e-6)
            else:                    # reduce_act: the sum's block; grad gathered
                tot = sum(seq(r) for r in model)
                np.testing.assert_allclose(out, tot[:, lo:hi], rtol=1e-5, atol=1e-6)
                gw = np.zeros((2, T, 4), np.float32)
                for k, r in enumerate(model):
                    klo, khi = min(T, k * b), min(T, (k + 1) * b)
                    gw[:, klo:khi] = w(r, (2, khi - klo, 4))
                np.testing.assert_allclose(grad, gw, rtol=1e-6)
