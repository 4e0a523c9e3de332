"""Training launcher of the port, on the card unless ``--device cpu`` is
given: random weights and the synthetic LM stream from one seed, AdamW
with warmup max(2, steps // 10) and cosine decay.

With more than one process (``DistributedSpec.from_env()``: the
``REPRO_*`` variables, or OpenMPI's / SLURM's) it trains on the JAX
launcher's ("data", "model") grid of ``run``'s ``mesh_shape``, (n, 1)
by default: data-parallel, every rank draws the same global batch and
takes its rows of it, the MoE layers dispatch over the global batch
and the gradients are averaged before the update.  A model axis above
1 makes the layers tensor- and expert-parallel over it: each rank keeps
its blocks of the params under ``launch.sharding``'s "ep" rules
(``training.loop.make_train_step``'s ``mesh``), each leaf cut to them as
soon as it is drawn (``init_params``' ``place``).  As in the JAX
launcher, no flag sets the grid: callers pass ``mesh_shape`` to
``run``.  The ranks check that they made the same params and batches
(the same blocks over the data axes, the same replicated leaves and
batches over the model axis); rank 0 alone prints, and writes the
checkpoints that every rank gathers.  On the card every rank computes
on the card it is bound to (gloo where ranks share one).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \\
      --n-layers 1 --steps 10 --batch 8 --seq 128
  # two ranks on the CPU (start one process per REPRO_PROCESS_ID):
  REPRO_COORDINATOR=127.0.0.1:29511 REPRO_NUM_PROCESSES=2 REPRO_PROCESS_ID=0 \\
      PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \\
      --reduced --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.config import get_config, reduced
from repro_torch.core.transport import DistributedSpec, MultiControllerTransport
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.mesh import data_axes, make_mesh
from repro_torch.models.stubs import extra_inputs
from repro_torch.models.transformer import REMAT, init_params
from repro_torch.serving.config import DTYPES
from repro_torch.training.checkpoint import save
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.data_parallel import check_replicated
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import AdamWConfig, init_opt_state, leaves


def run(arch: str, *, use_reduced: bool, steps: int, batch: int, seq: int,
        lr: float, mesh_shape=None, remat: str = "none",
        checkpoint_dir: str | None = None, log_every: int = 10,
        dtype: str = "float32", seed: int = 0, device="cuda", n_layers: int = 0):
    """Train ``steps`` steps; returns the losses (the grid's means).

    ``mesh_shape``: the ("data", "model") grid over the processes, (n, 1)
    by default; its product must be the number of processes."""
    dev = resolve_device(device)
    spec = DistributedSpec.from_env()
    if mesh_shape is None:
        mesh_shape = (spec.num_processes, 1)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    if len(mesh_shape) != 2 or mesh_shape[0] * mesh_shape[1] != spec.num_processes:
        raise ValueError(f"a ('data', 'model') grid of {mesh_shape} for "
                         f"{spec.num_processes} processes")
    mesh, rank = None, 0
    if spec.num_processes > 1:
        tr = MultiControllerTransport(spec, device=dev)
        dev, rank = tr.device, tr.process_index
        mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    extras = extra_inputs(cfg, batch, dtype=getattr(torch, dtype), device=dev)
    extras_keys = tuple(extras.keys())
    step_fn = make_train_step(
        cfg, AdamWConfig(lr=lr, warmup_steps=max(2, steps // 10),
                         total_steps=steps),
        remat=remat, extras_keys=extras_keys, mesh=mesh)
    specs = None
    if mesh is not None:
        # each leaf cut to the rank's block as soon as it is drawn
        specs = sharding.param_specs(cfg, init_params(cfg, device="meta"), mesh)
        params = init_params(cfg, seed, getattr(torch, dtype), device=dev,
                             place=step_fn.layout.place)
    else:
        params = init_params(cfg, seed, getattr(torch, dtype), device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    opt_state = init_opt_state(params)
    if mesh is not None:
        check_replicated(leaves(params) + list(extras.values()),
                         mesh.group(data_axes(mesh)), "params and stub inputs")
        whole = [p for (_, s), p in zip(sharding.named_specs(specs), leaves(params))
                 if "model" not in s.axes()]
        check_replicated(whole + list(extras.values()), mesh.group("model"),
                         "replicated params and stub inputs")
    data = iter(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                       batch=batch, seed=seed)))
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        toks = torch.from_numpy(next(data)).to(dev)
        if mesh is not None and step == 0:
            for axes in (data_axes(mesh), "model"):
                check_replicated([toks], mesh.group(axes), "batches")
        params, opt_state, metrics = step_fn(
            params, opt_state, toks, *(extras[k] for k in extras_keys))
        losses.append(float(metrics["loss"]))
        if log_every and step % log_every == 0:
            say(f"step {step:5d} loss {losses[-1]:8.4f} "
                f"lr {float(metrics['lr']):.2e}", flush=True)
    dt = time.perf_counter() - t0
    ranks = f" on a {mesh_shape} grid" if mesh is not None else ""
    say(f"trained {steps} steps in {dt:.1f}s{ranks} "
        f"({steps * batch * seq / dt:.0f} tok/s); "
        f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f}")
    if checkpoint_dir:
        save(checkpoint_dir, steps, params, opt_state, mesh=mesh, specs=specs)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the model to this many layers (0 = the config's)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none", choices=REMAT)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--dtype", default="float32", choices=DTYPES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback between "
                         "them; with several ranks each takes the card it "
                         "is bound to")
    args = ap.parse_args(argv)
    return run(args.arch, use_reduced=args.reduced, steps=args.steps,
               batch=args.batch, seq=args.seq, lr=args.lr, remat=args.remat,
               checkpoint_dir=args.checkpoint_dir, dtype=args.dtype,
               device=args.device, n_layers=args.n_layers)


if __name__ == "__main__":
    main()
