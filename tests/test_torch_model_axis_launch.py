"""``repro_torch.launch.train.run(mesh_shape=...)`` on gloo ranks of the
CPU (the ``REPRO_*`` variables, ``tests/_torch_dist_worker.py train``):

  * a (2, 2) and a (1, 2) ("data", "model") grid give the losses of
    ``run(mesh_shape=None)`` in one process within 1e-5 relative; each
    rank's blocks of step 0's gradients are within 1e-4 of each leaf's
    max |g| of one process's, and of the params after step 0 within what
    those gradients' gap allows through AdamW's first step
    (``adamw_first_step_bound``); the grid's checkpoint (gathered,
    written by rank 0) restores into one process at step 3;
  * mamba2 (``ssd``) and whisper (``selfcross`` and the encoder) on
    (1, 2) the same; llama-vision (``cross``) on (1, 2) the losses;
  * a grid whose product is not the number of processes raises;
  * recurrentgemma (``rglru``, once refused) on a model axis of 2 gives
    one process's losses on every rank.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.config import get_config, reduced
from _torch_dist_worker import keep_step0
from repro_torch.launch import sharding
from repro_torch.launch.dist_smoke import run_ranks
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.launch.train import run
from repro_torch.models.transformer import init_params
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import loop
from repro_torch.training.optimizer import (AdamWConfig, cosine_lr, init_opt_state,
                                            named_leaves)

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
    step0 = {}
    update = keep_step0(loop, step0)
    try:
        one = run(**dict(args, mesh_shape=None, checkpoint_dir=str(tmp_path / "one")))
    finally:
        loop.adamw_update = update
    cfg = reduced(get_config(arch))
    tmpl = init_params(cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=args["lr"], warmup_steps=max(2, args["steps"] // 10),
                          total_steps=args["steps"])
    for r in range(grid[0] * grid[1]):
        np.testing.assert_allclose(np.load(tmp_path / f"losses{r}.npy"), one,
                                   rtol=1e-5)
        with open(tmp_path / f"step0_{r}.pkl", "rb") as fh:
            rank0 = pickle.load(fh)
        mesh = RecordingMesh(grid, ("data", "model"), divmod(r, grid[1]))
        specs = sharding.named_specs(sharding.param_specs(cfg, tmpl, mesh))
        for i, ((k, _), (_, spec)) in enumerate(zip(named_leaves(tmpl), specs,
                                                    strict=True)):
            block = lambda a: sharding.local_shard(torch.from_numpy(a), spec,
                                                   mesh).numpy()
            g, g_one = rank0["grads"][i], block(step0["grads"][i])
            assert np.abs(g - g_one).max() <= 1e-4 * np.abs(g_one).max(), (r, k)
            d = np.abs(rank0["params"][i] - block(step0["params"][i]))
            allowed = adamw_first_step_bound(opt_cfg, step0["grad_norm"],
                                             np.abs(g - g_one),
                                             block(step0["params"][i]))
            assert (d <= allowed).all(), (r, k, float((d / allowed).max()))
    got, opt, step = tckpt.restore(str(tmp_path / "grid"), tmpl, init_opt_state(tmpl))
    assert step == 3 and int(opt.step) == 3


def adamw_first_step_bound(opt_cfg, gnorm, dg, want):
    """How far apart two runs' params may be after AdamW's first step
    from the same params, elementwise, where their gradients are ``dg``
    apart and one run's params are ``want``: the step moves an element by
    lr * g' / (|g'| + eps) (g' the clipped gradient; bias correction
    cancels) plus the decay both share; x / (|x| + eps) moves by at most
    |dx| / eps and never by more than 2, so lr * min(2, s * dg / eps)
    (s the clip scale), plus rounding: 1e-5 of the leaf's range and 1e-6
    of the element.  Where a gradient element sits near eps, the last
    bit of a sum decides a move of a good part of lr (chip_smoke.py
    phase 12(a)'s rule)."""
    lr = float(cosine_lr(opt_cfg, 1))
    clip = min(1.0, opt_cfg.grad_clip / (gnorm + 1e-9))
    rng = float(want.max() - want.min()) or 1.0
    return (lr * np.minimum(clip * dg / opt_cfg.eps, 2.0) + 1e-5 * rng
            + 1e-6 * np.abs(want))


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
