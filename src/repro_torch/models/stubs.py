"""Modality-frontend stubs, the JAX package's ``models/stubs.py`` in
PyTorch.

The [audio] and [vlm] frontends are stubs: this module supplies
precomputed frame / patch embeddings of the right shape.  The JAX
package draws them from ``jax.random.PRNGKey(0)`` (patches) and ``(1)``
(frames); the port draws them from a ``torch.Generator`` seeded 0 and 1
the same way (normal, times 0.02), so each package gives every request
the same stub, though the two packages' stubs differ.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device


def extra_inputs(cfg: ModelConfig, batch: int,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device="cuda") -> dict:
    """Concrete ``cross_embeds`` / ``frames`` stubs for a model, or {} if
    it needs none.  ``generator``: where to draw from (default: a fresh
    generator on ``device`` seeded 0 for patches and 1 for frames)."""
    dev = resolve_device(device)

    def draw(seed, S):
        gen = (generator if generator is not None
               else torch.Generator(device=dev).manual_seed(seed))
        x = torch.randn((batch, S, cfg.d_model), generator=gen,
                        dtype=torch.float32, device=dev)
        return (x * 0.02).to(dtype)

    out = {}
    if cfg.arch_type == "vlm":
        out["cross_embeds"] = draw(0, cfg.cross_source_len)
    if cfg.encoder is not None:
        out["frames"] = draw(1, cfg.encoder.source_len)
    return out
