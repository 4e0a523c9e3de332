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
free dim and ``zero_extend`` can land on it in JAX.  ``Layout`` (the
JAX dry run's training layouts) reads those two on JAX's stacked shape
(``jax_stacking``): a leaf or moment JAX splits on the block dim is held
whole by the data rank of that block.

JAX places a tree with ``to_shardings`` and lets GSPMD move the data;
here each rank holds its block (``local_shard``) and the model code runs
the collectives itself (``models.parallel``).  ``gather_full`` builds a
full tensor back from the blocks.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

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



# ---------------------------------------------------------------------------
# the JAX dry run's training layouts: fsdp, ep2d, ZeRO-1 moments, m2n
# ---------------------------------------------------------------------------


class DuplicateSpecError(ValueError):
    """A spec that names one mesh axis on two dims: JAX's
    ``DuplicateSpecError``, with its words.  The JAX dry run's
    ``zero_extend`` puts the data axes on a moment's first free dim that
    they divide without checking that fsdp or ep2d put them on another
    dim already, and ``NamedSharding`` then raises this."""


def _entry(ax) -> str:
    if isinstance(ax, tuple):
        return repr(ax[0]) if len(ax) == 1 else repr(ax)
    return repr(ax)


def check_spec(spec: Spec) -> Spec:
    """``spec``, or JAX's ``DuplicateSpecError`` where it names an axis
    twice."""
    seen = set()
    for a in spec.axes():
        if a in seen:
            raise DuplicateSpecError(
                "A single NamedSharding spec specification can map every mesh "
                "axis to at most one positional dimension, but PartitionSpec("
                f"{', '.join(_entry(x) for x in spec)}) has duplicate entries "
                f"for `{a}`")
        seen.add(a)
    return spec


def jax_stacking(cfg: ModelConfig, path: str):
    """(block, n_blocks) of the per-layer leaf at ``path`` where the JAX
    package stacks it on a leading dim of ``n_blocks`` (a block period's
    layer, an encoder layer), else None (a remainder layer, a top-level
    leaf)."""
    parts = path.split("/")
    if parts[0] == "layers":
        layer, period, nb = int(parts[1]), len(cfg.block_pattern), cfg.n_blocks
        return (layer // period, nb) if layer < nb * period else None
    if parts[:2] == ["encoder", "layers"]:
        return int(parts[2]), cfg.encoder.n_layers
    return None


_EXPERT_LEAVES = ("we1", "we3", "we2")


class LeafLayout(NamedTuple):
    """Where one leaf lives on a rank of a training layout.

    ``use``: the spec of the block the model code reads (the "ep" rules'),
    ``use_shape`` its shape on this rank.  ``held``: how the rank holds
    it between steps: "whole" (the use block), "gather" (its block of the
    use block over the data axes along ``dim``, made whole at its use),
    "owner" (the data rank ``owner`` holds the use block, the others an
    empty tensor: JAX splits the leaf on its stacked block dim), "local"
    (the use block itself is split over the data axes: m2n2d's experts).
    ``moment``: how the rank holds its AdamW moments: "held" (as the
    param), "split" (the held block's block over the data axes along
    ``mdim``: ZeRO-1), "owner" (whole on the data rank ``mowner``).
    ``jax``: the JAX spec of the (stacked) leaf, ``jax_moment`` its
    moments'."""
    path: str
    use: Spec
    use_shape: tuple
    held: str
    dim: Optional[int]
    owner: Optional[int]
    moment: str
    mdim: Optional[int]
    mowner: Optional[int]
    jax: Spec
    jax_moment: Spec


def _cut(shape, dim, n):
    out = list(shape)
    out[dim] //= n
    return tuple(out)


class Layout:
    """A training layout of the JAX dry run on ``mesh``: the params under
    ``param_specs(expert_mode=, fsdp=)`` (each per-layer leaf's spec read
    on JAX's stacked shape), the moments under ``zero_extend`` with
    ``zero`` (ZeRO-1), the experts in m2n's shard with ``moe_impl`` "m2n"
    or "m2n2d" (JAX reshards them to it at its ``shard_map`` each step).
    A spec JAX would refuse raises its ``DuplicateSpecError``.

    ``leaves``: a ``LeafLayout`` per leaf in ``named_leaves``' order."""

    def __init__(self, cfg: ModelConfig, mesh, *, expert_mode: str = "ep",
                 fsdp: bool = False, zero: bool = False, moe_impl: str = "baseline"):
        from repro_torch.models.transformer import init_params
        from repro_torch.training.optimizer import named_leaves
        self.cfg, self.mesh = cfg, mesh
        self.dt = data_axes(mesh)
        self.n_data = mesh.size(self.dt) if self.dt else 1
        self.i_data = mesh.index(self.dt) if self.dt else 0
        full = init_params(cfg, device="meta")
        m2n_shard, m2n_use, self.m2n = None, None, None
        if moe_impl in ("m2n", "m2n2d") and cfg.moe is not None:
            from repro_torch.core import m2n
            w2d = moe_impl == "m2n2d"
            self.m2n = w2d
            layer = next(lp for lp in full["layers"] if "we1" in lp)
            m2n_shard = {k: tuple(v.shape) for k, v in m2n.expert_shard(
                {k: layer[k] for k in _EXPERT_LEAVES}, cfg.moe, mesh.size("model"),
                mesh.index("model"), n_data=self.n_data if w2d else 1,
                i=self.i_data if w2d else 0).items()}
            # the axes of m2n's shard (its experts padded to whole buckets)
            dt2 = self.dt if w2d else None
            m2n_use = {"we1": Spec("model", None, dt2), "we3": Spec("model", None, dt2),
                       "we2": Spec("model", dt2, None)}
        self.leaves = []
        for path, t in named_leaves(full):
            self.leaves.append(self._leaf(path, tuple(t.shape), expert_mode, fsdp,
                                          zero, m2n_shard, m2n_use))
        self._by_path = {lf.path: lf for lf in self.leaves}

    def _leaf(self, path, shape, expert_mode, fsdp, zero, m2n_shard, m2n_use):
        mesh, dt, n = self.mesh, self.dt, self.n_data
        name = path.split("/")[-1]
        st = jax_stacking(self.cfg, path)
        jshape = (st[1],) + shape if st else shape
        J = check_spec(param_spec(name, jshape, mesh, expert_mode=expert_mode,
                                  fsdp=fsdp))
        M = check_spec(zero_extend(J, jshape, mesh)) if zero else J
        owner_of = lambda block: block // (st[1] // n)
        moment, mdim, mowner = "held", None, None
        if M != J:
            k = next(k for k in range(len(jshape)) if M[k] != J[k])
            if st and k == 0:
                moment, mowner = "owner", owner_of(st[0])
            else:
                moment, mdim = "split", k - (1 if st else 0)
        if m2n_shard is not None and name in _EXPERT_LEAVES:
            # m2n's shard: JAX's moment block of it where the rank holds it
            # whole over the data axes; m2n2d's is its own block over them
            use = m2n_use[name]
            held = "local" if any(a in dt for a in use.axes()) else "whole"
            if held == "local" or (moment == "split" and m2n_shard[name][mdim] % n):
                moment, mdim, mowner = "held", None, None
            return LeafLayout(path, use, m2n_shard[name], held, None, None, moment,
                              mdim, mowner, J, M)
        use = param_spec(name, shape, mesh)
        use_shape = tuple(local_shard(torch.empty(shape, device="meta"), use,
                                      mesh).shape)
        held, dim, owner = "whole", None, None
        if st and J[0] is not None:
            held, owner = "owner", owner_of(st[0])
        else:
            H = Spec(*J[1:]) if st else J
            diff = [k for k in range(len(shape)) if H[k] != use[k]]
            if diff:
                k = diff[0]
                if len(diff) > 1 or use[k] is not None or tuple(H[k]) != tuple(dt):
                    raise NotImplementedError(f"{path}: {H} is not {use} with the "
                                              f"data axes on one more dim")
                held, dim = "gather", k
        return LeafLayout(path, use, use_shape, held, dim, owner, moment, mdim,
                          mowner, J, M)

    def leaf(self, path: str) -> LeafLayout:
        return self._by_path[path]

    # -- shapes and blocks -------------------------------------------------

    def held_shape(self, lf: LeafLayout) -> tuple:
        if lf.held == "gather":
            return _cut(lf.use_shape, lf.dim, self.n_data)
        if lf.held == "owner" and lf.owner != self.i_data:
            return (0,)
        return lf.use_shape

    def moment_shape(self, lf: LeafLayout) -> tuple:
        if lf.moment == "split":
            return _cut(lf.use_shape, lf.mdim, self.n_data)
        if lf.moment == "owner":
            return lf.use_shape if lf.mowner == self.i_data else (0,)
        return self.held_shape(lf)

    def place(self, path: str, t: torch.Tensor, what: str = "held") -> torch.Tensor:
        """This rank's block of the whole leaf ``t`` at ``path``: the one it
        holds (``what="held"``), or the one its moments cover and AdamW
        updates (``"moment"``: the gradient it updates with, too)."""
        lf = self.leaf(path)
        name = path.split("/")[-1]
        if self.m2n is not None and name in _EXPERT_LEAVES:
            # m2n's shard of the experts (``core.m2n.expert_shard``)
            m, j = self.mesh.size("model"), self.mesh.index("model")
            e_loc = -(-self.cfg.moe.n_experts // m)
            u = t[j * e_loc:min(t.shape[0], (j + 1) * e_loc)]
            if self.m2n:
                f = 2 if name == "we2" else 3
                fb = self.cfg.moe.d_ff_expert // self.n_data
                u = u.narrow(f - 1, self.i_data * fb, fb)
            if what == "moment":
                u = self.moment_block(lf, u)
                if u is None:
                    return t.new_empty((0,))
            return u.clone(memory_format=torch.contiguous_format)
        u = local_shard(t, lf.use, self.mesh)
        kind, dim, owner = lf.held, lf.dim, lf.owner
        if what == "moment" and lf.moment != "held":
            kind = "gather" if lf.moment == "split" else "owner"
            dim, owner = lf.mdim, lf.mowner
        if kind == "gather":
            b = u.shape[dim] // self.n_data
            return u.narrow(dim, self.i_data * b, b).clone(
                memory_format=torch.contiguous_format)
        if kind == "owner" and owner != self.i_data:
            return t.new_empty((0,))
        return u

    def moment_block(self, lf: LeafLayout, held: torch.Tensor):
        """The block of a rank's held leaf that its moments cover (what
        AdamW updates there), or None where another data rank updates
        it."""
        if lf.moment == "split":
            b = held.shape[lf.mdim] // self.n_data
            return held.narrow(lf.mdim, self.i_data * b, b)
        if lf.moment == "owner" and lf.mowner != self.i_data:
            return None
        return held

    def place_tree(self, tree, what: str = "held"):
        """``place`` of every leaf of a whole params tree."""
        def walk(t, prefix):
            if isinstance(t, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(walk(v, f"{prefix}/{i}") for i, v in enumerate(t))
            return self.place(prefix, t, what)
        return walk(tree, "")

    def init_opt_state(self, params, moment_dtype=torch.float32):
        """Zero moments in the layout's blocks (``training.optimizer``'s
        ``OptState``) for this rank's held ``params``."""
        from repro_torch.training.optimizer import OptState
        if isinstance(moment_dtype, str):
            moment_dtype = getattr(torch, moment_dtype)

        def build(tree, prefix=""):
            if isinstance(tree, torch.Tensor):
                return torch.zeros(self.moment_shape(self.leaf(prefix)),
                                   dtype=moment_dtype, device=tree.device)
            if isinstance(tree, dict):
                return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in tree.items()}
            return type(tree)(build(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))

        return OptState(torch.zeros((), dtype=torch.int32), build(params),
                        build(params))

    # -- the leaves at their use -------------------------------------------

    def use(self, tree: dict, prefix: str) -> dict:
        """``tree``'s leaves as the model code reads them (the hook of
        ``models.parallel.use_params``): a "gather" leaf all-gathered over
        the data axes (reduce-scatter backward), an "owner" leaf sent from
        its owner (its gradient summed to it)."""
        from repro_torch.models import parallel
        out = None
        for k, v in tree.items():
            if not isinstance(v, torch.Tensor):
                continue
            lf = self._by_path.get(f"{prefix}/{k}" if prefix else k)
            if lf is None or lf.held in ("whole", "local"):
                continue
            if out is None:
                out = dict(tree)
            if lf.held == "gather":
                out[k] = parallel.gather_data(v, self.mesh, self.dt, lf.dim)
            else:
                out[k] = parallel.from_owner(v, self.mesh, self.dt, lf.owner,
                                             lf.use_shape)
        return tree if out is None else out

    def use_all(self, tree, prefix: str = ""):
        """Every leaf of ``tree`` as the model code reads it (a serving
        pass: the whole tree at the pass's start)."""
        if isinstance(tree, dict):
            top = self.use(tree, prefix)
            return {k: (self.use_all(v, f"{prefix}/{k}" if prefix else k)
                        if isinstance(v, (dict, list)) else top[k])
                    for k, v in tree.items()}
        return [self.use_all(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
