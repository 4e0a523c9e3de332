"""Training loop: chunked cross-entropy LM loss, the train step, the
single-process ``train``; the JAX package's ``training/loop.py`` in
PyTorch.

The LM head and the softmax cross-entropy run over token chunks, each
under ``torch.utils.checkpoint``, so only one (chunk, V) block of logits
is alive at a time, in backward too (JAX: ``lax.map`` over
``jax.checkpoint``).

Parameters are plain tensors that require grad.  A train step runs the
loss forward, ``backward()``, and ``adamw_update`` over the ``.grad``
tensors, then clears them.  The path reaches no CUDA kernel of the
port: the kernels have no backward, and their wrappers refuse an input
that requires grad.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import rms_norm, softcap
from repro_torch.models.transformer import forward_hidden
from repro_torch.training.optimizer import (AdamWConfig, OptState, adamw_update,
                                            decay_mask, init_opt_state, leaves)


def chunked_xent(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
                 targets: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy without the whole (B, T, V) logits.

    hidden: (B, T, d) pre-final-norm activations; targets: (B, T) int.
    The chunk shrinks to a divisor of B * T, as in JAX."""
    B, T, d = hidden.shape
    h = rms_norm(hidden, params["final_norm"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    n = B * T
    chunk = min(chunk, n)
    while n % chunk:
        chunk -= 1
    hc = h.reshape(n // chunk, chunk, d)
    tc = targets.reshape(n // chunk, chunk).long()

    def one(hb, tb):
        logits = hb @ w.to(hb.dtype)
        if cfg.logit_softcap:
            logits = softcap(logits, cfg.logit_softcap)
        lp = F.log_softmax(logits.float(), dim=-1)
        return -lp.gather(-1, tb[:, None]).sum()

    losses = [checkpoint(one, hc[i], tc[i], use_reentrant=False)
              for i in range(n // chunk)]
    return torch.stack(losses).sum() / n


def lm_loss(params: dict, cfg: ModelConfig, tokens: torch.Tensor, extras: dict,
            remat: str = "full", aux_coef: float = 0.01, xent_chunk: int = 1024):
    """(total, (loss, aux)): next-token loss of ``tokens`` (B, T + 1)
    plus ``aux_coef`` times the MoE load-balance loss."""
    hidden, aux = forward_hidden(params, cfg, tokens[:, :-1], remat=remat,
                                 **extras)
    loss = chunked_xent(params, cfg, hidden, tokens[:, 1:], chunk=xent_chunk)
    return loss + aux_coef * aux, (loss, aux)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: str = "full", xent_chunk: int = 1024,
                    extras_keys: tuple = ()):
    """Returns train_step(params, opt_state, tokens, *extras) ->
    (params, opt_state, metrics): metrics {"loss", "aux", "total", "lr",
    "grad_norm"}, 0-d tensors.  ``params`` are updated in place, weight
    decay on the leaves of ``decay_mask`` (JAX's rule on its stacked
    tree)."""

    def train_step(params, opt_state: OptState, tokens, *extra_vals):
        extras = dict(zip(extras_keys, extra_vals))
        total, (loss, aux) = lm_loss(params, cfg, tokens, extras, remat,
                                     xent_chunk=xent_chunk)
        total.backward()
        ps = leaves(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ps]
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state,
                                             decay=decay_mask(params, cfg))
        for p in ps:
            p.grad = None
        return params, opt_state, {"loss": loss.detach(), "aux": aux.detach(),
                                   "total": total.detach(), **om}

    return train_step


@dataclass
class TrainResult:
    losses: list
    steps: int
    tokens_per_s: float


def train(cfg: ModelConfig, params, data_iter, *, steps: int = 100,
          opt_cfg: Optional[AdamWConfig] = None, remat: str = "none",
          log_every: int = 10, extras_fn: Optional[Callable] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
          device="cuda") -> TrainResult:
    """Single-process training loop.  ``params`` (on ``device``) are
    made to require grad and trained in place; batches are numpy arrays
    from ``data_iter``.  As the JAX ``train``, it draws one sample batch
    from a fresh iterator of ``data_iter`` (for ``extras_fn``'s batch
    size) before training from another.  The moments are kept in f32,
    as by the JAX ``train``, whatever ``opt_cfg.moment_dtype`` says."""
    from repro_torch.training import checkpoint as ckpt

    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    for p in leaves(params):
        p.requires_grad_(True)
    opt_state = init_opt_state(params)
    sample = next(iter(data_iter))
    extras = extras_fn(sample.shape[0]) if extras_fn else {}
    extras_keys = tuple(extras.keys())
    step_fn = make_train_step(cfg, opt_cfg, remat=remat, extras_keys=extras_keys)
    losses = []
    t0 = time.perf_counter()
    n_tokens = 0
    it = iter(data_iter)
    for step in range(steps):
        batch = torch.from_numpy(next(it)).to(dev)
        params, opt_state, metrics = step_fn(
            params, opt_state, batch, *(extras[k] for k in extras_keys))
        n_tokens += batch.numel()
        loss = float(metrics["loss"])
        losses.append(loss)
        if log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        if checkpoint_dir and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, step + 1, params, opt_state)
    dt = time.perf_counter() - t0
    return TrainResult(losses, steps, n_tokens / dt)
