"""``repro_torch.launch.train.run(mesh_shape=...)`` on gloo ranks of the
CPU (the ``REPRO_*`` variables, ``tests/_torch_dist_worker.py train``):

  * a (2, 2) and a (1, 2) ("data", "model") grid give the losses of
    ``run(mesh_shape=None)`` in one process within 1e-5 relative, and the
    grid's checkpoint (gathered, written by rank 0) restores into one
    process with the one-process run's params within 1e-4 of each
    leaf's max |p| but for at most 1e-4 of its elements;
  * mamba2 (``ssd``) and whisper (``selfcross`` and the encoder) on
    (1, 2) the same; llama-vision (``cross``) on (1, 2) the losses;
  * a grid whose product is not the number of processes raises;
  * recurrentgemma (``rglru``, once refused) on a model axis of 2 gives
    one process's losses on every rank.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.config import get_config, reduced
from repro_torch.launch.dist_smoke import run_ranks
from repro_torch.launch.train import run
from repro_torch.models.transformer import init_params
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.optimizer import init_opt_state, named_leaves

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")


def _ranks(tmp_path, args, n):
    return run_ranks([WORKER, "train", str(tmp_path), json.dumps(args)], n,
                     timeout=120, coordinator=f"file://{tmp_path}/store")


@pytest.mark.parametrize("arch,grid", [("mixtral-8x22b", (2, 2)),
                                       ("gemma2-27b", (1, 2)),
                                       ("mamba2-1.3b", (1, 2)),
                                       ("whisper-large-v3", (1, 2))])
def test_run_on_a_grid_matches_one_process(tmp_path, arch, grid):
    args = dict(arch=arch, use_reduced=True, steps=3, batch=4, seq=16, lr=1e-3,
                log_every=0, device="cpu", mesh_shape=list(grid),
                checkpoint_dir=str(tmp_path / "grid"))
    out = _ranks(tmp_path, args, grid[0] * grid[1])
    for rank, (rc, text) in enumerate(out):
        assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"
    one = run(**dict(args, mesh_shape=None, checkpoint_dir=str(tmp_path / "one")))
    for r in range(grid[0] * grid[1]):
        np.testing.assert_allclose(np.load(tmp_path / f"losses{r}.npy"), one,
                                   rtol=1e-5)
    cfg = reduced(get_config(arch))
    tmpl = init_params(cfg, device="cpu")
    got, opt, step = tckpt.restore(str(tmp_path / "grid"), tmpl, init_opt_state(tmpl))
    want, _, _ = tckpt.restore(str(tmp_path / "one"), tmpl)
    assert step == 3 and int(opt.step) == 3
    for (k, a), (_, b) in zip(named_leaves(got), named_leaves(want), strict=True):
        err = (a - b).abs()
        off = err > 1e-4 * b.abs().max()
        assert off.sum() <= 1e-4 * err.numel(), (k, int(off.sum()))


def test_run_trains_llama_vision_on_a_grid(tmp_path):
    """llama-vision's cross layer on a (1, 2) grid: every rank's losses
    within 1e-5 of one process's.  Its tanh gates start at 0, so the
    cross leaves' first updates ride on gradients near AdamW's eps and
    their params are noise-level here; they are held against JAX with the
    gates opened (``test_torch_model_axis_kinds.py``)."""
    args = dict(arch="llama-3.2-vision-90b", use_reduced=True, steps=3, batch=4,
                seq=16, lr=1e-3, log_every=0, device="cpu", mesh_shape=[1, 2])
    out = _ranks(tmp_path, args, 2)
    for rank, (rc, text) in enumerate(out):
        assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"
    one = run(**dict(args, mesh_shape=None))
    for r in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"losses{r}.npy"), one,
                                   rtol=1e-5)


def test_a_grid_of_another_size_raises():
    with pytest.raises(ValueError, match="grid of"):
        run("mixtral-8x22b", use_reduced=True, steps=1, batch=2, seq=8, lr=1e-3,
            device="cpu", mesh_shape=(1, 2))


def test_rglru_on_a_model_axis_fails_every_rank(tmp_path):
    """Once a refusal: recurrentgemma now trains on a model axis of 2,
    every rank's losses within 1e-5 of one process's."""
    args = dict(arch="recurrentgemma-2b", use_reduced=True, steps=2, batch=2,
                seq=8, lr=1e-3, log_every=0, device="cpu", mesh_shape=[1, 2])
    out = _ranks(tmp_path, args, 2)
    for rank, (rc, text) in enumerate(out):
        assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"
    one = run(**dict(args, mesh_shape=None))
    for r in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"losses{r}.npy"), one,
                                   rtol=1e-5)
