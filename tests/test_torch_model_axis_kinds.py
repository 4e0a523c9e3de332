"""Training on a (data, model) process grid for the layer kinds besides
``attn`` / ``local`` (``ssd``, ``rglru``, ``cross``, ``selfcross`` with
the whisper encoder) and for query heads that do not split over "model",
against the JAX step sharded on the same grid, on the CPU.

The pattern of ``test_torch_model_axis.py``: gloo ranks from
``dist_smoke.run_ranks`` (``tests/_torch_dist_worker.py grid``), each
holding its blocks of the JAX ``init_params`` draw under the "ep" rules,
and the JAX launcher's step on the same grid in a child with 4 forced
host devices (``tests/_torch_grid_ref.py``: params placed by
``shlib.param_specs``, GSPMD sharding the step).  The stub inputs are the
JAX package's (frames, patches), handed to both; llama-vision's cross
gates are opened to 0.5, as the family tests open them.  The configs,
reduced:
  * mamba2: 16 SSD heads; ``in_proj``'s 1072 columns and the conv's 544
    cut into blocks that straddle the [z | x | B | C | dt] segments;
  * recurrentgemma: RG-LRU over the width, the local ring (1 kv head),
    tied embeddings; also on (1, 4);
  * whisper: the encoder and the self+cross decoder, kv heads split;
  * llama-vision: the gated cross layer (1 kv head, its weight cut
    mid-head and gathered); on (1, 3) nothing of its attention splits;
  * minitron with 6 query heads on (1, 4): 1.5 heads a rank, ``wq`` and
    ``wk`` / ``wv`` cut mid-head.
Held, with ``test_torch_model_axis.py``'s tolerances: the steps' losses
within 1e-5 relative (the second after an update on the rank's blocks);
step 0's gradients, gathered, within 1e-5 of each leaf's max |g| (the
0-d cross gates within 1e-4, the family tests' tolerance: each is one
sum over every token and channel, and JAX's own step on the (2, 2) grid
puts ``gate_attn``'s gradient 1.02e-5 of it away from its step on one
device); the
gradient of every leaf the rules leave whole equal on every model rank;
the grid's checkpoint restores into one process as the gathered params;
(in the ranks) the ``forward_train`` logits within 1e-5 of one
process's.  The params after the steps are not held elementwise: AdamW
turns a gradient element near 0 into an update of about the lr whatever
its size, so rounding moves such elements, and on the 256-element
leaves here (norms, RG-LRU gate biases) the port's own one-process and
grid runs part past ``test_torch_model_axis.py``'s loose rule in two
steps (recurrentgemma and gemma2 alike).
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
from repro_torch.bridge import params_from_jax
from repro_torch.launch.dist_smoke import run_ranks
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.optimizer import init_opt_state, named_leaves

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
REF = os.path.join(HERE, "_torch_grid_ref.py")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
STEPS, BATCH, SEQ = 2, 4, 17
# (case, arch, query heads (None: the reduced config's 4), grid, remat)
CASES = [
    ("mamba2-1x2", "mamba2-1.3b", None, (1, 2), "none"),
    ("mamba2-2x2", "mamba2-1.3b", None, (2, 2), "none"),
    ("recurrentgemma-1x2-full", "recurrentgemma-2b", None, (1, 2), "full"),
    ("recurrentgemma-2x2", "recurrentgemma-2b", None, (2, 2), "none"),
    ("recurrentgemma-1x4", "recurrentgemma-2b", None, (1, 4), "none"),
    ("whisper-1x2", "whisper-large-v3", None, (1, 2), "none"),
    ("whisper-2x2", "whisper-large-v3", None, (2, 2), "none"),
    ("llama-vision-1x2", "llama-3.2-vision-90b", None, (1, 2), "none"),
    ("llama-vision-2x2", "llama-3.2-vision-90b", None, (2, 2), "none"),
    ("llama-vision-1x3", "llama-3.2-vision-90b", None, (1, 3), "none"),
    ("minitron-6h-1x4", "minitron-4b", 6, (1, 4), "none"),
]
GRIDS = [(1, 2), (2, 2), (1, 4), (1, 3)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX reference, [each rank's results], the grid's checkpoint)}."""
    jax = pytest.importorskip("jax")
    from repro import config as jconfig
    from repro.models import stubs as jstubs
    from repro.models import transformer as jtf

    tmp = tmp_path_factory.mktemp("kinds")
    refs, inputs = [], {g: [] for g in GRIDS}
    for name, arch, n_heads, grid, remat in CASES:
        jcfg = jconfig.reduced(jconfig.get_config(arch),
                               **({"n_heads": n_heads} if n_heads else {}))
        pj = open_gates(jax.tree.map(np.asarray,
                                     jtf.init_params(jcfg, jax.random.PRNGKey(0))))
        toks = np.random.RandomState(3).randint(
            0, jcfg.vocab, (STEPS, BATCH, SEQ)).astype(np.int32)
        extras = {k: np.asarray(v) for k, v in jstubs.extra_inputs(jcfg, BATCH).items()}
        case = {"name": name, "arch": arch, "n_heads": n_heads, "grid": grid,
                "remat": remat, "opt": OPT, "tokens": toks, "params": pj,
                "extras": extras}
        refs.append(dict(case, key=name))
        ck = str(tmp / f"one-{name}")
        p0 = params_from_jax(pj, grid_config(case), device="cpu")
        tckpt.save(ck, 0, p0, init_opt_state(p0))
        inputs[grid].append(dict(case, ckpt=ck))
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
            out = run_ranks([WORKER, "grid", str(d / "in.pkl"), str(d)], n,
                            timeout=180, coordinator=f"file://{d}/store")
            for rank, (rc, text) in enumerate(out):
                assert rc == 0, f"{grid} rank {rank} exit {rc}:\n{text[-3000:]}"
            ranks = []
            for r in range(n):
                with open(d / f"grid{r}.pkl", "rb") as fh:
                    ranks.append(pickle.load(fh))
            for case in inputs[grid]:
                got[case["name"]] = ([r[case["name"]] for r in ranks],
                                     str(d / f"ck-{case['name']}"))
        text, _ = jax_child.communicate(timeout=400)
    finally:
        jax_child.kill()
    assert jax_child.returncode == 0, text[-3000:]
    with open(tmp / "want.pkl", "rb") as fh:
        want = pickle.load(fh)
    return {name: (want[name], *got[name]) for name, *_ in CASES}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_grid_training_of_every_kind_matches_the_jax_step(runs, case):
    want, ranks, ck = runs[case]
    _, arch, n_heads, grid, _ = next(c for c in CASES if c[0] == case)
    cfg = grid_config({"arch": arch, "n_heads": n_heads})
    tree = lambda t: dict(named_leaves(params_from_jax(t, cfg, device="cpu")))
    for r in ranks:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], want["loss"],
                                   rtol=1e-5)
    m = grid[1]
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
        tol = 1e-4 if w.ndim == 0 else 1e-5
        assert err <= tol * scale, f"{k}: {err:.3e} > {tol} x {scale:.3e}"
    tmpl = params_from_jax(want["params"], cfg, device="cpu")
    back, opt, step = tckpt.restore(ck, tmpl, init_opt_state(tmpl))
    assert step == STEPS and int(opt.step) == STEPS
    for k, t in named_leaves(back):
        assert np.array_equal(t.numpy(), ranks[0]["params"][k]), k
