"""Sharding rules of the port: the JAX package's ``launch/sharding.py``
without JAX, over a ``launch.mesh.ProcessMesh`` (or any object with its
``shape`` dict and ``axis_names``).

The rules are JAX's, one for one:
  * batch / tokens            -> data axes ("pod", "data")
  * attention weights         -> tensor-parallel over "model" (heads)
  * routed expert weights     -> expert-parallel over "model" (experts;
                                 TP over d_ff where E does not divide,
                                 replicated as a last resort)
  * embeddings / lm_head      -> the vocabulary over "model"
  * KV caches                 -> batch over data, kv heads over "model"
                                 (else the sequence)
Every rule checks divisibility against the mesh, so one rule set serves
every (arch x shape x mesh).

A ``Spec`` has one entry per dim of its tensor: None (whole), an axis
name, or a tuple of axis names (split over their product, row-major in
the tuple's order).  A rule names the entries of the trailing dims, as
in JAX.  The port's parameter tree holds one dict per layer where JAX
stacks a block period's layers on a leading ``n_blocks`` dim, so a
leaf's spec here is JAX's with that dim dropped; only ``fsdp``'s first
free dim and ``zero_extend`` can land on it in JAX, and they take the
first free dim of the per-layer leaf here.

JAX places a tree with ``to_shardings`` and lets GSPMD move the data;
here each rank holds its block (``local_shard``) and the model code runs
the collectives itself (``models.parallel``).  ``gather_full`` builds a
full tensor back from the blocks.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.config import ModelConfig
from repro_torch.launch.mesh import data_axes, model_axis


class Spec(tuple):
    """A sharding spec: one entry per dim (None, an axis, or a tuple of
    axes)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"

    def axes(self):
        """Every axis the spec names, in order."""
        out = []
        for ax in self:
            out += [] if ax is None else list(ax if isinstance(ax, tuple) else (ax,))
        return tuple(out)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    return math.prod(mesh.shape[a] for a in
                     (axis if isinstance(axis, tuple) else (axis,)))


def _div(n: int, mesh, axis) -> bool:
    return n % _axis_size(mesh, axis) == 0


def _spec(shape, mesh, *rule) -> Spec:
    """Per-dim axis suggestions for the TRAILING dims, dropping any that
    do not divide."""
    pads = len(shape) - len(rule)
    out = [None] * pads
    for dim, axis in zip(shape[pads:], rule):
        out.append(axis if _div(dim, mesh, axis) else None)
    return Spec(*out)


def _replicated(shape) -> Spec:
    return Spec(*[None] * len(shape))


def param_spec(name: str, shape, mesh, *, expert_mode: str = "ep",
               fsdp: bool = False) -> Spec:
    """Sharding rule for one parameter by name (trailing-dim semantics).

    expert_mode "ep": experts over "model", replicated over data; "ep2d":
    experts over "model" and d_ff over the data axes.  fsdp: also shard
    big dense weights over the data axes, on their first free dim that
    divides."""
    mdl = model_axis(mesh)
    dt = data_axes(mesh)
    r = lambda *rule: _spec(shape, mesh, *rule)

    def maybe_fsdp(spec: Spec) -> Spec:
        if not fsdp or len(shape) < 2:
            return spec
        parts = list(spec)
        for i, (ax, dim) in enumerate(zip(parts, shape)):
            if ax is None and _div(dim, mesh, dt):
                parts[i] = dt
                return Spec(*parts)
        return spec

    if name == "embed":
        return maybe_fsdp(r(mdl, None))
    if name == "lm_head":
        return maybe_fsdp(r(None, mdl))
    if name in ("wq", "wk", "wv", "c_wq", "c_wk", "c_wv"):
        return maybe_fsdp(r(None, mdl))
    if name in ("wo", "c_wo"):
        return maybe_fsdp(r(mdl, None))
    if name in ("w1", "w3", "ws1", "ws3", "wd1", "wd3"):
        return maybe_fsdp(r(None, mdl))
    if name in ("w2", "ws2", "wd2"):
        return maybe_fsdp(r(mdl, None))
    if name in ("we1", "we3"):
        E, d, f = shape[-3:]
        if _div(E, mesh, mdl):
            if expert_mode == "ep2d" and _div(f, mesh, dt):
                return r(mdl, None, dt)
            return maybe_fsdp(r(mdl, None, None))
        if expert_mode == "ep2d" and _div(f, mesh, mdl) and _div(d, mesh, dt):
            return r(None, dt, mdl)
        return r(None, None, mdl)
    if name == "we2":
        E, f, d = shape[-3:]
        if _div(E, mesh, mdl):
            if expert_mode == "ep2d" and _div(f, mesh, dt):
                return r(mdl, dt, None)
            return maybe_fsdp(r(mdl, None, None))
        if expert_mode == "ep2d" and _div(f, mesh, mdl) and _div(d, mesh, dt):
            return r(None, mdl, dt)
        return r(None, mdl, None)
    if name in ("w_in_x", "w_in_gate"):
        return r(None, mdl)
    if name == "w_out":
        return r(mdl, None)
    if name in ("w_a", "w_x"):
        return r(None, mdl)
    if name == "conv_w":
        return r(None, mdl)
    if name in ("b_a", "b_x", "lam", "norm", "dt_bias", "A_log", "D"):
        return r(mdl)
    if name == "in_proj":
        return r(None, mdl)
    if name == "out_proj":
        return r(mdl, None)
    if name == "pos_embed":
        return r(None, None)
    # router, norms, gates, shared_gate -> replicated
    return _replicated(shape)


def param_specs(cfg: ModelConfig, params, mesh, *, expert_mode: str = "ep",
                fsdp: bool = False):
    """A tree of ``Spec``s of the params tree's structure (dicts and lists;
    a leaf is anything with a ``shape``, a meta tensor too)."""

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return param_spec(name, tuple(tree.shape), mesh, expert_mode=expert_mode,
                          fsdp=fsdp)

    return walk(params)


def cache_entry_specs(entry_shapes: dict, mesh, batch: int) -> dict:
    """Sharding of one layer's cache entry."""
    dt = data_axes(mesh)
    mdl = model_axis(mesh)
    batch_ok = _div(batch, mesh, dt)
    b_ax = dt if batch_ok else None
    # kv layout: batch over data; kv heads over model when they divide,
    # else the sequence over model (or over data when the batch does not
    # divide)
    kv_entry = entry_shapes.get("k")
    if kv_entry is None:
        kv_entry = entry_shapes.get("k_src")
    h_ax = w_ax = None
    if kv_entry is not None:
        if _div(kv_entry.shape[-2], mesh, mdl):
            h_ax = mdl
            w_ax = None if batch_ok else dt
        else:
            w_ax = mdl if batch_ok else dt
    out = {}
    for k, v in entry_shapes.items():
        s = tuple(v.shape)
        if k in ("k", "v", "k_src", "v_src"):
            out[k] = _spec(s, mesh, b_ax, w_ax, h_ax, None)
        elif k == "pos":
            out[k] = _spec(s, mesh, b_ax, w_ax)
        elif k == "ssm":      # (B, h, p, n)
            out[k] = _spec(s, mesh, b_ax, mdl, None, None)
        elif k == "conv":     # (B, K-1, width)
            out[k] = _spec(s, mesh, b_ax, None, mdl)
        elif k == "h":        # (B, W)
            out[k] = _spec(s, mesh, b_ax, mdl)
        else:
            out[k] = _replicated(s)
    return out


def cache_specs(cfg: ModelConfig, cache_shapes, mesh, batch: int) -> list:
    """Per-layer cache entry specs of the port's cache (a list of
    per-layer dicts)."""
    return [cache_entry_specs(e, mesh, batch) for e in cache_shapes]


def input_spec(shape, mesh) -> Spec:
    """Token / position arrays: batch over the data axes when it
    divides."""
    dt = data_axes(mesh)
    return _spec(shape, mesh, *((dt,) + (None,) * (len(shape) - 1)))


def zero_extend(spec: Spec, shape, mesh) -> Spec:
    """ZeRO-1: also shard an optimizer moment over the data axes, on its
    first free dim that the data axes' size divides (the JAX dry run's
    rule, ``launch/dryrun.py``)."""
    dt = data_axes(mesh)
    n = _axis_size(mesh, dt) if dt else 1
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and dim % n == 0:
            parts[i] = dt
            return Spec(*parts)
    return Spec(*parts)


# ---------------------------------------------------------------------------
# blocks on ranks
# ---------------------------------------------------------------------------


def _block(spec: Spec, shape: Sequence[int], mesh):
    """This rank's block of a ``shape`` tensor under ``spec``: a slice per
    dim."""
    out = []
    for ax, dim in zip(spec, shape):
        if ax is None:
            out.append(slice(None))
            continue
        idx, n = 0, 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            idx = idx * mesh.shape[a] + mesh.index(a)
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"{spec} does not divide {tuple(shape)}")
        b = dim // n
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def local_shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a
    contiguous copy, or ``t`` itself when nothing is split).  A copy even
    where the block is contiguous already (a block of the first dim): a
    view would keep the whole tensor's storage alive."""
    if len(spec) != t.ndim:
        raise ValueError(f"{spec} for a {t.ndim}-d tensor")
    if _axis_size(mesh, spec.axes()) == 1:
        return t
    return t[_block(spec, t.shape, mesh)].clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def gather_full(shard: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's block: each rank writes its block
    into a zero-filled tensor of the full shape and the ranks that hold
    the other blocks sum it (an ``all_reduce``, since gloo has no CUDA
    ``all_gather``).  Every rank of those groups must call it."""
    axes = spec.axes()
    if _axis_size(mesh, axes) == 1:
        return shard
    full = shard.new_zeros([d * _axis_size(mesh, ax)
                            for d, ax in zip(shard.shape, spec)])
    full[_block(spec, full.shape, mesh)] = shard
    return mesh.all_reduce(full, axes)


def named_specs(specs, prefix: str = ""):
    """(path, spec) for every ``Spec`` of a spec tree, in
    ``training.optimizer.named_leaves``' order (dict keys sorted)."""
    if isinstance(specs, Spec):
        yield prefix, specs
        return
    items = sorted(specs.items()) if isinstance(specs, dict) else enumerate(specs)
    for k, v in items:
        yield from named_specs(v, f"{prefix}/{k}" if prefix else str(k))


def tree_map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors and its spec tree."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """``local_shard`` of every leaf."""
    return tree_map2(lambda t, s: local_shard(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """``gather_full`` of every leaf, in the tree's order (every rank must
    walk the same tree)."""
    return tree_map2(lambda t, s: gather_full(t, s, mesh), tree, specs)


def shard_cache(cache, mesh, batch=None):
    """This rank's block of every entry of a whole cache (the port's list
    of per-layer dicts) under ``cache_entry_specs``: the rows over the
    data axes where ``batch`` (the global batch; default the cache's
    rows) divides them, the kv heads over "model" where they divide it,
    else the ring's slots, ``pos`` cut as the slots."""
    if batch is None:
        batch = next(iter(cache[0].values())).shape[0]
    return shard_tree(cache, cache_specs(None, cache, mesh, batch), mesh)


def gather_cache(blocks, cfg: ModelConfig, mesh, batch: int, max_seq: int):
    """The whole cache from every rank's blocks (``shard_cache``'s
    inverse; every rank of the grid must call it)."""
    from repro_torch.models import stubs
    full = stubs.cache_specs(cfg, batch, max_seq)
    return gather_tree(blocks, cache_specs(cfg, full, mesh, batch), mesh)

