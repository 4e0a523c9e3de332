"""Training loop: chunked cross-entropy LM loss, the train step, the
single-process ``train``; the JAX package's ``training/loop.py`` in
PyTorch.

The LM head and the softmax cross-entropy run over token chunks, each
under ``torch.utils.checkpoint``, so only one (chunk, V) block of logits
is alive at a time, in backward too (JAX: ``lax.map`` over
``jax.checkpoint``).  Under a model axis that splits the vocabulary a
rank holds (chunk, V / m) of them.

On a (data, model) grid (``make_train_step(mesh=...)``) the step is the
JAX step under ``launch/sharding.py``'s "ep" rules: the rows split over
the data axes, each rank's shards of the weights computing under
``models.parallel`` (tensor- and expert-parallel over "model").

Parameters are plain tensors that require grad.  A train step runs the
loss forward, ``backward()``, and ``adamw_update`` over the ``.grad``
tensors, then clears them.  The path reaches no CUDA kernel of the
port: the kernels have no backward, and their wrappers refuse an input
that requires grad.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.mesh import data_axes
from repro_torch.models import parallel
from repro_torch.models.common import rms_norm, softcap
from repro_torch.models.transformer import (forward_hidden, head_weight,
                                            init_params, vocab_block)
from repro_torch.training import data_parallel as dp
from repro_torch.training.optimizer import (AdamWConfig, OptState, adamw_update,
                                            decay_mask, init_opt_state, leaves)


def chunked_xent(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
                 targets: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy without the whole (B, T, V) logits.

    hidden: (B, T, d) pre-final-norm activations; targets: (B, T) int.
    The chunk shrinks to a divisor of B * T, as in JAX.

    Under a model axis that splits the vocabulary (``models.parallel``)
    each rank makes the logits of its columns: -log p(t) = lse - z_t,
    where the logsumexp combines the ranks' own (each rank's in a row of
    a zero-filled (m, chunk) buffer, summed: no max collective) and z_t
    is the logit of the rank that holds t, summed with the others' 0."""
    B, T, d = hidden.shape
    h = rms_norm(hidden, params["final_norm"])
    w = head_weight(params, cfg)
    mp, cols = vocab_block(params, cfg)
    n = B * T
    chunk = min(chunk, n)
    while n % chunk:
        chunk -= 1
    hc = h.reshape(n // chunk, chunk, d)
    tc = targets.reshape(n // chunk, chunk).long()

    def one(hb, tb):
        if mp is not None:
            hb = mp.enter(hb)
        logits = hb @ w.to(hb.dtype)
        if cfg.logit_softcap:
            logits = softcap(logits, cfg.logit_softcap)
        if mp is None:
            lp = F.log_softmax(logits.float(), dim=-1)
            return -lp.gather(-1, tb[:, None]).sum()
        lf = logits.float()
        lse = torch.logsumexp(mp.gather(torch.logsumexp(lf, -1)[None], 0), 0)
        ids = tb - cols.start
        mine = (ids >= 0) & (ids < lf.shape[-1])
        z = lf.gather(-1, torch.where(mine, ids, 0)[:, None])[:, 0]
        return (lse - mp.reduce(z * mine)).sum()

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


def _grid_norm(grads, split, mesh) -> torch.Tensor:
    """The global norm of a rank's gradients where ``split`` marks the
    leaves of which it holds a block over "model": their squares summed
    over the axis, each replicated leaf's counted once."""
    sharded = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    whole = torch.zeros_like(sharded)
    for g, s in zip(grads, split, strict=True):
        gf = g.reshape(-1).float()
        if s:
            sharded = sharded + gf @ gf
        else:
            whole = whole + gf @ gf
    return torch.sqrt(mesh.all_reduce(sharded, "model") + whole)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: str = "full", xent_chunk: int = 1024,
                    extras_keys: tuple = (), group=None, mesh=None):
    """Returns train_step(params, opt_state, tokens, *extras) ->
    (params, opt_state, metrics): metrics {"loss", "aux", "total", "lr",
    "grad_norm"}, 0-d tensors.  ``params`` are updated in place, weight
    decay on the leaves of ``decay_mask`` (JAX's rule on its stacked
    tree).

    ``group``: a process group of R data-parallel ranks, each passing
    the same global batch (tokens and extras).  Each rank takes its
    B / R rows and the MoE layers dispatch as the JAX step does over the
    global batch (``data_parallel.DataParallelMoE``); every gradient is
    summed over the group and divided by R before the norm and the clip,
    so every rank makes the same update; the metrics are the group's
    means.  Where B does not split over R every rank runs the whole
    batch (the JAX layout replicates it then: ``launch/sharding.py``'s
    divisibility rule) and the mean changes nothing.  With the rows split, the metrics also hold "dropped": the
    entries past their expert's capacity in the global batch, summed
    over the MoE layers.

    ``mesh``: a ``launch.mesh.ProcessMesh`` over ("data", "model") (or
    ("pod", "data", "model")) in place of ``group``: the rows split over
    the data axes as above, and each rank passes its shards of the
    params under ``launch.sharding.param_specs``' "ep" rules
    (``sharding.local_shard``) and of the optimizer state alike.  The
    model code runs on them under ``models.parallel`` (every kind of
    ``parallel.KINDS``: attention, cross attention, RG-LRU, SSD); a
    replicated leaf's gradient is the same on every model rank, every
    gradient is averaged over the data axes, the clip's global norm
    counts each sharded element once, and AdamW updates each rank's
    blocks.  The metrics hold "dropped"."""
    n_data, mp, split = dp.group_size(group), None, None
    if mesh is not None:
        group, n_data = mesh.group(data_axes(mesh)), mesh.size(data_axes(mesh))
        if mesh.size("model") > 1:
            parallel.check_kinds(cfg.layer_kinds)
            mp = parallel.ModelParallel(mesh)
        full = init_params(cfg, device="meta")
        specs = [s for _, s in sharding.named_specs(
            sharding.param_specs(cfg, full, mesh))]
        split = ["model" in s.axes() for s in specs]
        local = [sharding.local_shard(t, s, mesh).shape
                 for t, s in zip(leaves(full), specs, strict=True)]

    def train_step(params, opt_state: OptState, tokens, *extra_vals):
        if mesh is not None and [p.shape for p in leaves(params)] != local:
            raise ValueError("the params are not this rank's shards under the "
                             "mesh's 'ep' rules (sharding.local_shard)")
        extras = dict(zip(extras_keys, extra_vals))
        moe = None
        rows = n_data > 1 and tokens.shape[0] % n_data == 0
        if rows:
            tokens = dp.local_rows(tokens, group)
            extras = {k: dp.local_rows(v, group) for k, v in extras.items()}
        if rows or mesh is not None:
            moe = dp.DataParallelMoE(group if rows else None)
        # the dispatch and the model axis stay installed through backward,
        # whose recompute of a checkpointed block period (remat) must run
        # as the forward did, collectives included
        with contextlib.ExitStack() as stack:
            if moe is not None:
                stack.enter_context(moe.install())
            if mp is not None:
                stack.enter_context(mp.install())
            total, (loss, aux) = lm_loss(params, cfg, tokens, extras, remat,
                                         xent_chunk=xent_chunk)
            if moe is not None:
                moe.count_drops = False
            total.backward()
        ps = leaves(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ps]
        metrics = torch.stack([loss, aux, total]).detach()
        if n_data > 1:
            dp.average_grads(grads + [metrics], group)
        gnorm = _grid_norm(grads, split, mesh) if mp is not None else None
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state,
                                             decay=decay_mask(params, cfg),
                                             gnorm=gnorm)
        for p in ps:
            p.grad = None
        om.update(loss=metrics[0], aux=metrics[1], total=metrics[2])
        if moe is not None:
            om["dropped"] = moe.dropped
        return params, opt_state, om

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
