"""Data-parallel training on the port (``make_train_step(group=...)``,
``training.data_parallel``, ``launch.train`` over ``REPRO_*`` ranks)
against the JAX step on one device with the whole batch, on the CPU.

Two gloo ranks (processes from ``dist_smoke.run_ranks``) each take half
of the batch; their MoE layers dispatch as the JAX step does over the
global batch (global capacity, global slot positions, global aux), and
their gradients are averaged before the update.  Params are the JAX
``init_params`` draw carried over by ``repro_torch.bridge``; batches are
numpy.  Tolerances:
  * step 0's loss and aux: rtol 1e-6;
  * step 0's averaged gradients: within 5e-6 of each leaf's max |g|;
  * the second step's loss: rtol 1e-4 (``test_torch_training.py``'s);
  * the params after two steps: loosely (chip_smoke's phase 8(a)
    rule): at most 1e-4 of the elements past 1e-5 of their leaf's range,
    none by as much as the lr summed over the steps.  Splitting the batch
    changes the order of the gradient sums, and AdamW's first step moves
    an element whose gradient cancels to ~0 by nearly +-lr.
The MoE cases run where tokens are dropped (the global capacity binds),
so the count prefix decides which entries stay.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config, reduced
from repro_torch.launch.dist_smoke import run_ranks
from repro_torch.training.optimizer import named_leaves

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
STEPS = 2
# (case, arch, batch rows, remat): two MoE configs, a dense one, a batch
# that does not split over 2 ranks (replicated, as the JAX layout does),
# and mixtral under both remat modes, whose backward recomputes the
# global dispatch of each block period
CASES = [("mixtral", "mixtral-8x22b", 4, "none"),
         ("qwen2-moe", "qwen2-moe-a2.7b", 4, "none"),
         ("dense", "minitron-4b", 4, "none"),
         ("odd-batch", "mixtral-8x22b", 3, "none"),
         ("mixtral-remat-full", "mixtral-8x22b", 4, "full"),
         ("mixtral-remat-dots", "mixtral-8x22b", 4, "dots")]
SEQ = 17


def _ranks(argv, n, tmp, timeout=150):
    out = run_ranks(argv, n, timeout=timeout, coordinator=f"file://{tmp}/store")
    for rank, (rc, text) in enumerate(out):
        assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX results, the port's 2-rank results)}."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import config as jconfig
    from repro.models import transformer as jtf
    from repro.training import loop as jloop
    from repro.training import optimizer as jopt

    tmp = tmp_path_factory.mktemp("dp")
    want, cases = {}, []
    for name, arch, batch, remat in CASES:
        jcfg = jconfig.reduced(jconfig.get_config(arch))
        pj = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        toks = np.random.RandomState(3).randint(
            0, jcfg.vocab, (STEPS, batch, SEQ)).astype(np.int32)
        (_, (loss, aux)), grads = jax.jit(
            jax.value_and_grad(jloop.lm_loss, has_aux=True),
            static_argnums=(1, 4))(pj, jcfg, jnp.asarray(toks[0]), {}, remat)
        step = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**OPT),
                                             remat=remat))
        params, state, losses = pj, jopt.init_opt_state(pj), []
        for s in range(STEPS):
            params, state, m = step(params, state, jnp.asarray(toks[s]))
            losses.append(float(m["loss"]))
        tcfg = reduced(get_config(arch))
        to_t = lambda tree: dict(named_leaves(params_from_jax(
            jax.tree.map(np.asarray, tree), tcfg, device="cpu")))
        want[name] = {"loss": float(loss), "aux": float(aux), "losses": losses,
                      "grads": to_t(grads), "params": to_t(params),
                      "lr": [float(jopt.cosine_lr(jopt.AdamWConfig(**OPT), s + 1))
                             for s in range(STEPS)]}
        cases.append({"name": name, "arch": arch, "opt": OPT, "tokens": toks,
                      "remat": remat,
                      "params": jax.tree.map(np.asarray, pj)})
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    _ranks([WORKER, "dp", str(tmp / "in.pkl"), str(tmp)], 2, tmp)
    with open(tmp / "dp.pkl", "rb") as fh:
        got = pickle.load(fh)
    return {name: (want[name], got[name]) for name, *_ in CASES}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_two_rank_step_matches_the_jax_global_step(runs, case):
    want, got = runs[case]
    m0 = got["metrics"][0]
    np.testing.assert_allclose(m0["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(m0["aux"], want["aux"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], want["losses"],
                               rtol=1e-4)
    assert got["grads"].keys() == want["grads"].keys()
    for k, g in got["grads"].items():
        w = want["grads"][k].numpy()
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 5e-6 * scale, f"{k}: {err:.3e} > 5e-6 x {scale:.3e}"
    lr_sum = sum(want["lr"])
    n_off = n_all = 0
    for k, p in got["params"].items():
        w = want["params"][k].numpy()
        d = np.abs(p - w)
        rng = float(w.max() - w.min()) or 1.0
        assert d.max() < lr_sum, (k, float(d.max()))
        n_off += int((d > 1e-5 * rng).sum())
        n_all += d.size
    assert n_off <= 1e-4 * n_all, (n_off, n_all)
    moe = reduced(get_config(dict((c[0], c[1]) for c in CASES)[case])).moe
    if case == "odd-batch":
        assert "dropped" not in m0       # replicated: the plain dispatch
    elif moe is not None:
        # the global capacity binds: some entries are dropped in both steps
        assert all(m["dropped"] > 0 for m in got["metrics"]), got["metrics"]
        if case.startswith("mixtral-remat"):
            # backward's recompute of the dispatch is not counted again
            assert ([m["dropped"] for m in got["metrics"]]
                    == [m["dropped"] for m in runs["mixtral"][1]["metrics"]])
    else:
        assert all(m["dropped"] == 0 for m in got["metrics"])
