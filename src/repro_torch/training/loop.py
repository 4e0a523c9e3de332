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
``models.parallel`` (tensor- and expert-parallel over "model"); or a
train record of the JAX dry run under fsdp, ep2d, ZeRO-1, m2n or
sequence parallelism (``launch.sharding.Layout``).

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
from repro_torch.core import m2n
from repro_torch.launch import sharding
from repro_torch.launch.mesh import data_axes
from repro_torch.models import parallel
from repro_torch.models.common import rms_norm, softcap
from repro_torch.models.transformer import forward_hidden, head_weight, vocab_block
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
    params = parallel.use_params(params, "")
    hidden, aux = forward_hidden(params, cfg, tokens[:, :-1], remat=remat,
                                 **extras)
    loss = chunked_xent(params, cfg, hidden, tokens[:, 1:], chunk=xent_chunk)
    return loss + aux_coef * aux, (loss, aux)


def _layout_norm(pieces, axes, mesh) -> torch.Tensor:
    """The global norm of the gradient blocks a rank holds, ``pieces[k]``
    a block over ``axes[k]`` (the axes its leaf is split over; empty
    where the rank holds it whole, or another rank holds it): each group
    of leaves split over the same axes summed over them, so every
    element counts once."""
    zero = torch.zeros((), dtype=torch.float32, device=pieces[0].device)
    sums = {(): torch.zeros_like(zero)}
    for g, ax in zip(pieces, axes, strict=True):
        gf = g.reshape(-1).float()
        sums[ax] = sums.get(ax, zero) + gf @ gf
    total = sums.pop(())
    for ax, v in sums.items():
        total = mesh.all_reduce(v, ax) + total
    return torch.sqrt(total)


def _sync_layout(layout, params, grads, n_data):
    """Each gradient of a rank's held ``params`` brought to its moment's
    block, the data axes' mean: (param blocks, gradient blocks, the axes
    each block splits over).  A leaf the rank holds whole is summed over
    the data axes (reduce-scattered to a ZeRO-1 block); one held split
    over them, or by one of them, was summed by its gather's backward."""
    mesh, dt = layout.mesh, layout.dt
    ps, gs, axes = [], [], []
    for lf, p, g in zip(layout.leaves, params, grads, strict=True):
        ax = lf.use.axes()
        if lf.held == "whole":
            if lf.moment == "split":
                g = mesh.reduce_scatter(g, dt, lf.mdim)
            else:
                mesh.all_reduce(g, dt)
            p = layout.moment_block(lf, p)
            if p is None:           # another data rank updates this leaf
                p, g = g.new_empty((0,)), g.new_empty((0,))
            if lf.moment != "held":
                ax = ax + dt
        else:
            ax = ax + tuple(a for a in dt if a not in ax)
        g.div_(n_data)
        ps.append(p)
        gs.append(g)
        axes.append(tuple(a for a in mesh.axis_names if a in ax))
    return ps, gs, axes


@torch.no_grad()
def _regather(layout, params):
    """After the update: each leaf held whole whose moments are a block of
    it (ZeRO-1) all-gathered back over the data axes, or sent from the
    data rank that updated it."""
    mesh, dt, i = layout.mesh, layout.dt, layout.i_data
    for lf, p in zip(layout.leaves, params, strict=True):
        if lf.held != "whole" or lf.moment == "held":
            continue
        if lf.moment == "split":
            p.copy_(mesh.all_gather(layout.moment_block(lf, p).contiguous(), dt,
                                    lf.mdim))
        else:
            t = p.clone() if lf.mowner == i else torch.zeros_like(p)
            p.copy_(mesh.all_reduce(t, dt))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: str = "full", xent_chunk: int = 1024,
                    extras_keys: tuple = (), group=None, mesh=None,
                    expert_mode: str = "ep", fsdp: bool = False,
                    zero: bool = False, moe_impl: str = "baseline",
                    seq_parallel: bool = False):
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
    blocks.  The metrics hold "dropped".

    The JAX dry run's other layouts of a train record, on ``mesh``
    (``launch.sharding.Layout``; the rank's params and moments are the
    layout's blocks: ``Layout.place``, ``train_step.layout.init_opt_state``):

      * ``fsdp``: each large dense leaf split over the data axes on its
        first free dim they divide, made whole at its use (an all-gather,
        reduce-scattered backward, inside the remat recompute too); a
        leaf JAX splits on its stacked block dim is held whole by the
        data rank that holds that block and sent from it;
      * ``expert_mode="ep2d"``: each expert's d_ff split over the data
        axes, gathered at its use as an fsdp leaf;
      * ``zero``: ZeRO-1, each moment under ``sharding.zero_extend``: the
        gradient reduce-scattered over the data axes to the moment's
        block, AdamW on that block, the param all-gathered back;
      * ``moe_impl`` "m2n" / "m2n2d": the routed experts through
        ``core.m2n``'s plain branch (JAX's ``use_kernels=False``, which
        it takes under autograd), routing and
        capacity per data block, each rank holding its m2n expert shard
        (d_ff split over the data axes under "m2n2d"); no "dropped";
      * ``seq_parallel``: JAX's ``ACT_SPEC``: the block periods hold each
        rank's block of the sequence (``models.parallel``).

    A layout JAX refuses (``zero_extend`` naming the data axes twice)
    raises ``sharding.DuplicateSpecError`` here."""
    n_data, mp, layout = dp.group_size(group), None, None
    if mesh is not None:
        group, n_data = mesh.group(data_axes(mesh)), mesh.size(data_axes(mesh))
        if mesh.size("model") > 1:
            parallel.check_kinds(cfg.layer_kinds)
            mp = parallel.ModelParallel(mesh, seq_parallel=seq_parallel)
        layout = sharding.Layout(cfg, mesh, expert_mode=expert_mode, fsdp=fsdp,
                                 zero=zero, moe_impl=moe_impl)
        local = [layout.held_shape(lf) for lf in layout.leaves]
    elif (fsdp or zero or expert_mode != "ep" or moe_impl != "baseline"
          or seq_parallel):
        raise ValueError("fsdp, ep2d, ZeRO-1, m2n and sequence parallelism "
                         "need a mesh")
    m2n_impl = moe_impl in ("m2n", "m2n2d") and cfg.moe is not None

    def train_step(params, opt_state: OptState, tokens, *extra_vals):
        if mesh is not None and [tuple(p.shape) for p in leaves(params)] != local:
            raise ValueError("the params are not this rank's blocks of the "
                             "mesh's layout (sharding.Layout.place)")
        extras = dict(zip(extras_keys, extra_vals))
        moe = None
        rows = n_data > 1 and tokens.shape[0] % n_data == 0
        if rows:
            tokens = dp.local_rows(tokens, group)
            extras = {k: dp.local_rows(v, group) for k, v in extras.items()}
        if (rows or mesh is not None) and not m2n_impl:
            moe = dp.DataParallelMoE(group if rows else None)
        # the dispatch, the model axis and the layout's gathers stay
        # installed through backward, whose recompute of a checkpointed
        # block period (remat) must run as the forward did, collectives
        # included
        with contextlib.ExitStack() as stack:
            if moe is not None:
                stack.enter_context(moe.install())
            if m2n_impl:
                dt = data_axes(mesh) if rows else ()
                stack.enter_context(m2n.use_m2n(
                    mesh=mesh, data_axes=dt, expert_axis="model",
                    weights_2d=moe_impl == "m2n2d"))
            if mp is not None:
                stack.enter_context(mp.install())
            if layout is not None:
                stack.enter_context(parallel.gathering(layout))
            total, (loss, aux) = lm_loss(params, cfg, tokens, extras, remat,
                                         xent_chunk=xent_chunk)
            if moe is not None:
                moe.count_drops = False
            total.backward()
        ps = leaves(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ps]
        metrics = torch.stack([loss, aux, total]).detach()
        decay = decay_mask(params, cfg)
        if layout is not None:
            ps, grads, axes = _sync_layout(layout, ps, grads, n_data)
            dp.average_grads([metrics], group)
            gnorm = _layout_norm(grads, axes, mesh)
            _, opt_state, om = adamw_update(opt_cfg, ps, grads, opt_state,
                                            decay=decay, gnorm=gnorm)
            _regather(layout, leaves(params))
        else:
            if n_data > 1:
                dp.average_grads(grads + [metrics], group)
            params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state,
                                                 decay=decay)
        for p in leaves(params):
            p.grad = None
        om.update(loss=metrics[0], aux=metrics[1], total=metrics[2])
        if moe is not None:
            om["dropped"] = moe.dropped
        return params, opt_state, om

    train_step.layout = layout
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
