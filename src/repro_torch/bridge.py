"""Bridge from the JAX package's parameter and cache pytrees to the port's.

Input: the pytree of ``repro.models.init_params`` / ``init_cache`` with
its leaves as numpy arrays (``jax.tree.map(np.asarray, tree)``).  The
stacked ``blocks`` leading axis is unstacked into one dict per layer and
the ``remainder`` layers follow, in execution order.  The bridge takes
numpy only: it imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    # a copy: the port updates its cache in place, and numpy views of
    # JAX buffers are read-only
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _layers(tree: dict, cfg: ModelConfig, device) -> List[dict]:
    """Per-layer dicts from ``{"blocks": (stacked dict per pattern
    position), "remainder": (dict per remainder layer)}``."""
    out = []
    for blk in range(cfg.n_blocks):
        for pat in range(len(cfg.block_pattern)):
            out.append({k: _tensor(v[blk], device)
                        for k, v in tree["blocks"][pat].items()})
    for entry in tree["remainder"]:
        out.append({k: _tensor(v, device) for k, v in entry.items()})
    return out


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    params = {k: _tensor(tree[k], dev) for k in ("embed", "final_norm", "lm_head")
              if k in tree}
    params["layers"] = _layers(tree, cfg, dev)
    return params


def cache_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> List[dict]:
    return _layers(tree, cfg, resolve_device(device))
