"""Training launcher of the port, on the card unless ``--device cpu`` is
given: random weights and the synthetic LM stream from one seed, AdamW
with warmup max(2, steps // 10) and cosine decay, one process on one
device (no mesh, no sharding).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \\
      --n-layers 1 --steps 10 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.config import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.stubs import extra_inputs
from repro_torch.models.transformer import REMAT, init_params
from repro_torch.serving.config import DTYPES
from repro_torch.training.checkpoint import save
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import AdamWConfig, init_opt_state, leaves


def run(arch: str, *, use_reduced: bool, steps: int, batch: int, seq: int,
        lr: float, remat: str = "none", checkpoint_dir: str | None = None,
        log_every: int = 10, dtype: str = "float32", seed: int = 0,
        device="cuda", n_layers: int = 0):
    """Train ``steps`` steps; returns the losses."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(cfg, seed, getattr(torch, dtype), device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(2, steps // 10),
                          total_steps=steps)
    opt_state = init_opt_state(params)
    extras = extra_inputs(cfg, batch, dtype=getattr(torch, dtype), device=dev)
    extras_keys = tuple(extras.keys())
    step_fn = make_train_step(cfg, opt_cfg, remat=remat, extras_keys=extras_keys)
    data = iter(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                       batch=batch, seed=seed)))
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        toks = torch.from_numpy(next(data)).to(dev)
        params, opt_state, metrics = step_fn(
            params, opt_state, toks, *(extras[k] for k in extras_keys))
        losses.append(float(metrics["loss"]))
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:8.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
    dt = time.perf_counter() - t0
    print(f"trained {steps} steps in {dt:.1f}s "
          f"({steps * batch * seq / dt:.0f} tok/s); "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f}")
    if checkpoint_dir:
        save(checkpoint_dir, steps, params, opt_state)
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
                    help="cuda (default) or cpu; there is no fallback between them")
    args = ap.parse_args(argv)
    return run(args.arch, use_reduced=args.reduced, steps=args.steps,
               batch=args.batch, seq=args.seq, lr=args.lr, remat=args.remat,
               checkpoint_dir=args.checkpoint_dir, dtype=args.dtype,
               device=args.device, n_layers=args.n_layers)


if __name__ == "__main__":
    main()
