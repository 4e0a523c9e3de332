"""Bridge from the JAX package's parameter, cache and page-pool pytrees
to the port's.

Input: the pytree of ``repro.models.init_params`` / ``init_cache``, a
``repro.training.optimizer.OptState``, or a
``repro.serving.pages.PagePool``'s ``store``, with its leaves as numpy
arrays (``jax.tree.map(np.asarray, tree)``).  The
stacked ``blocks`` leading axis is unstacked into one dict per layer and
the ``remainder`` layers follow, in execution order; the whisper
encoder's stacked ``encoder.blocks`` become ``encoder.layers``.  Every
leaf of every layer kind crosses as it is (recurrent states, conv
caches, cross K/V, the 0-d gates).  The bridge takes
numpy only: it imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import OptState


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
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": [{k: _tensor(v[i], dev) for k, v in enc["blocks"].items()}
                       for i in range(cfg.encoder.n_layers)],
            "pos_embed": _tensor(enc["pos_embed"], dev),
            "final_norm": _tensor(enc["final_norm"], dev)}
    return params


def opt_state_from_jax(opt_state, cfg: ModelConfig, device="cuda"):
    """A JAX ``training.optimizer.OptState`` (``step``, ``mu``, ``nu``;
    numpy leaves) as the port's ``OptState``: the step a 0-d int32 host
    tensor, each moment tree unstacked as ``params_from_jax`` unstacks
    the params.  Gradients have the params' structure and cross with
    ``params_from_jax``."""
    step, mu, nu = opt_state
    return OptState(torch.tensor(int(np.asarray(step)), dtype=torch.int32),
                    params_from_jax(mu, cfg, device),
                    params_from_jax(nu, cfg, device))


def cache_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> List[dict]:
    return _layers(tree, cfg, resolve_device(device))


def pages_from_jax(store: dict, cfg: ModelConfig, device="cuda") -> List[dict]:
    """A JAX ``PagePool.store`` (leaves ``(n_blocks, P, ps, ...)``) as the
    port's per-layer page store ``{k, v: (P, ps, Hkv, hd), pos: (P, ps)}``
    (``serving.pages.PagePool.store``)."""
    return _layers(store, cfg, resolve_device(device))
