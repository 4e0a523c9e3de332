"""Checkpointing of parameter and optimizer trees, in the JAX package's
on-disk layout: one ``step_%08d/`` directory per save holding
``params.npz``, ``opt_state.npz`` and ``manifest.json``, the last
``keep`` of them kept.

Keys are the "/"-joined paths of the port's own trees
(``optimizer.named_leaves``: ``layers/0/wq``, ``mu/embed``, ...).  numpy
has no bfloat16, so a bf16 leaf is written as its uint16 bit pattern
and restored bit for bit; ``restore`` gives each leaf its template's
dtype and device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import OptState, named_leaves


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if a.dtype != np.uint16:
            raise ValueError(f"bf16 leaf stored as {a.dtype}, not its uint16 bits")
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True)).to(like.dtype)
    return t.to(like.device)


def _flatten(tree) -> dict:
    if isinstance(tree, OptState):
        tree = tree._asdict()
    return {k: _to_numpy(v) for k, v in named_leaves(tree)}


def _steps(directory: str):
    return sorted(d for d in os.listdir(directory) if d.startswith("step_"))


def save(directory: str, step: int, params, opt_state=None, keep: int = 3,
         extra: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_state.npz"), **_flatten(opt_state))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    for old in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, old))
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    ckpts = _steps(directory)
    return int(ckpts[-1].split("_")[1]) if ckpts else None


def _load(npz_path: str, template):
    """A tree of ``template``'s structure, dtypes and devices from an npz
    whose keys are exactly the template's paths."""
    as_state = isinstance(template, OptState)
    tmpl = template._asdict() if as_state else template
    paths = dict(named_leaves(tmpl))
    with np.load(npz_path) as data:
        if set(data.keys()) != set(paths):
            raise ValueError("checkpoint/template mismatch: "
                             f"{sorted(set(data.keys()) ^ set(paths))}")
        arrays = {k: data[k] for k in paths}

    def rebuild(tree, prefix):
        if isinstance(tree, torch.Tensor):
            return _from_numpy(arrays[prefix], tree)
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
               for k, v in items}
        return out if isinstance(tree, dict) else type(tree)(out.values())

    out = rebuild(tmpl, "")
    return OptState(**out) if as_state else out


def restore(directory: str, template_params, template_opt=None,
            step: int | None = None) -> Tuple[Any, Any, int]:
    """Restore into the structure of the given templates."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    params = _load(os.path.join(path, "params.npz"), template_params)
    opt = None
    if template_opt is not None and os.path.exists(
            os.path.join(path, "opt_state.npz")):
        opt = _load(os.path.join(path, "opt_state.npz"), template_opt)
    return params, opt, step
