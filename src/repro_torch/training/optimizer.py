"""AdamW and its schedule, the JAX package's ``training/optimizer.py`` in
PyTorch, with its arithmetic: f32 math whatever the leaves' dtypes, the
clip scale ``min(1, grad_clip / (gnorm + 1e-9))``, bias correction with
the step as f32, decoupled weight decay on leaves of two or more
dimensions only, moments stored in ``moment_dtype``.

The JAX update sees the stacked tree, where every leaf of a periodic
block carries the leading block axis: a per-layer vector (a norm scale,
SSD's ``A_log``, an RG-LRU gate bias) is a 2-D leaf there and is
decayed, while the same vector in a remainder layer is not.  The port
unstacks the blocks, so the train step hands ``adamw_update`` the
``decay_mask`` of its model, which counts that axis back in.

``torch.optim.AdamW`` with ``clip_grad_norm_`` is not that update: it
decays every leaf unless given parameter groups, clips with ``+ 1e-6``
and applies the decay before the moment step.

The update runs leaf by leaf under ``torch.no_grad()`` and writes the
parameters and moments in place; the gradients serve as its scratch.
An f32 leaf then needs no temporary of its size (mixtral-8x22b's expert
leaves are 805 M elements, 3.2 GB each in f32); a leaf or moment in
another dtype is updated through f32 copies of it.

Trees are nested dicts and lists of tensors (the port's parameter
layout); ``named_leaves`` walks them in a fixed order, dict keys sorted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0
    # "float32" (default) or "bfloat16"
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor       # 0-d int32, on the host
    mu: dict
    nu: dict


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) for every leaf of a tree of dicts / lists / tuples,
    dict keys in sorted order, the path's parts joined by "/"."""
    if tree is None or isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))


def leaves(tree):
    return [t for _, t in named_leaves(tree)]


def tree_map(fn, tree):
    """``fn`` over every tensor leaf, keeping the structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(tree_map(fn, v) for v in tree)


def decay_mask(params, cfg) -> List[bool]:
    """Which leaves of a model's params take weight decay, in
    ``named_leaves`` order: JAX's ``ndim >= 2`` rule on the stacked
    tree.  A leaf of one of the first ``n_blocks * len(block_pattern)``
    layers, or of the encoder's layers (stacked in JAX too), counts one
    dimension more than it has; a remainder layer's and a top-level
    leaf count their own.  ``cfg``: the model's ``ModelConfig``."""
    n_stacked = cfg.n_blocks * len(cfg.block_pattern)
    mask = []
    for path, p in named_leaves(params):
        parts = path.split("/")
        stacked = ((parts[0] == "layers" and int(parts[1]) < n_stacked)
                   or parts[:2] == ["encoder", "layers"])
        mask.append(p.ndim + stacked >= 2)
    return mask


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio * lr``, in f32
    as the JAX function computes it.  Returns a 0-d f32 tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params, moment_dtype=torch.float32) -> OptState:
    dt = _dtype(moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)
    return OptState(torch.zeros((), dtype=torch.int32), tree_map(zeros, params),
                    tree_map(zeros, params))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = None
    for g in leaves(tree):
        gf = g.reshape(-1).float()
        sq = gf @ gf
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState,
                 decay: Optional[List[bool]] = None):
    """One AdamW step.  Writes ``params`` and the moments in place and
    uses ``grads`` (a tree of the params' structure) as scratch: they
    hold no gradient afterwards.  ``decay``: per leaf, whether it takes
    weight decay (a model's ``decay_mask``); by default the leaves of
    two or more dimensions.  Returns (params, new state, metrics {"lr",
    "grad_norm"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr_t = cosine_lr(cfg, step)
    lr = float(lr_t)
    sf = step.to(torch.float32)
    bc1 = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** sf)
    bc2 = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** sf)
    ps = leaves(params)
    if decay is None:
        decay = [p.ndim >= 2 for p in ps]
    for p, g, mu, nu, dec in zip(ps, leaves(grads), leaves(state.mu),
                                 leaves(state.nu), decay, strict=True):
        pf, gf, mf, nf = _f32(p), _f32(g), _f32(mu), _f32(nu)
        gf.mul_(scale)
        mf.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        nf.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
        # the gradient's buffer becomes the denominator sqrt(nu_hat) + eps
        torch.div(nf, bc2, out=gf).sqrt_().add_(cfg.eps)
        # p - lr * (mu_hat / denom + wd * p)
        if dec:
            pf.mul_(1 - lr * cfg.weight_decay)
        pf.addcdiv_(mf, gf, value=-lr / bc1)
        for dst, src in ((p, pf), (mu, mf), (nu, nf)):
            if dst is not src:
                dst.copy_(src)
    return params, OptState(step, state.mu, state.nu), {"lr": lr_t,
                                                        "grad_norm": gnorm}
