"""The process grid of the port: the JAX package's ``launch/mesh.py`` over
``torch.distributed`` ranks.

A JAX mesh lays devices out in a grid with named axes; here one rank is
one device, and ``make_mesh(shape, axes)`` is ``init_device_mesh`` over
the ranks of the default process group, which lays them out row-major as
``jax.make_mesh`` lays out devices.  A collective "over an axis" runs in
that axis' group of the ``DeviceMesh``: the ranks that share every other
coordinate.  The default group must be up before (``core.transport``'s
``MultiControllerTransport`` brings it up): the mesh's groups then take
its backend, gloo where two ranks share a card, on which NCCL would
refuse them.  The production mesh of a TPU pod
(``make_production_mesh``) has no counterpart here; the dry run stands
``RecordingMesh`` in for one rank of it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

Axes = Union[str, Sequence[str]]


class ProcessMesh:
    """A grid of ranks with named axes: ``DeviceMesh`` ``dm``, or, with
    ``dm`` None, the grid of one rank of a process without a group.
    ``index(axes)`` is this rank's coordinate along ``axes`` (several
    axes combine row-major, as the JAX package's m2n combines its data
    axes); ``group(axes)`` the process group of the ranks that differ
    from it only along ``axes`` (None where that group is this rank
    alone: its collectives are the identity); ``size(axes)`` that
    group's size.  The group of several axes is the ``DeviceMesh``'s
    flattened one, made on first use: every rank must reach that use,
    in the same order, as every collective."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 dm: Optional[DeviceMesh] = None):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)
        self.device_mesh = dm

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Axes) -> int:
        idx = 0
        for a in self._axes(axes):
            local = 0 if self.device_mesh is None else \
                self.device_mesh.get_local_rank(a)
            idx = idx * self.shape[a] + local
        return idx

    def group(self, axes: Axes):
        axes = self._axes(axes)
        if self.device_mesh is None or self.size(axes) == 1:
            return None
        sub = self.device_mesh[axes]
        return (sub if len(axes) == 1 else sub._flatten()).get_group()

    def all_reduce(self, t: torch.Tensor, axes: Axes, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over ``axes``' group by ``op`` ("sum" or
        "max"; nothing to do when the group is this rank alone); returns
        ``t``.  Every collective of the model code goes through here or
        through ``all_gather`` / ``reduce_scatter``."""
        g = self.group(axes)
        if g is not None:
            dist.all_reduce(t, op=REDUCE_OPS[op], group=g)
        return t

    def all_gather(self, t: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` of ``axes``' group concatenated along ``dim``
        in the order of ``index(axes)`` (a new tensor; ``t`` itself where
        the group is this rank alone).  Over NCCL it is
        ``all_gather_into_tensor``; over gloo, whose CUDA collectives are
        ``all_reduce`` / ``broadcast`` only, each rank's block in a
        zero-filled tensor, summed.  The backend picks the branch: a
        failed collective is not retried the other way."""
        g = self.group(axes)
        if g is None:
            return t
        n, i = self.size(axes), self.index(axes)
        dim = dim % t.ndim
        if dist.get_backend(g) == "nccl":
            src = t.movedim(dim, 0).contiguous()
            out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=g)
            return out.movedim(0, dim).contiguous()
        shape = list(t.shape)
        b, shape[dim] = shape[dim], n * shape[dim]
        out = t.new_zeros(shape)
        out.narrow(dim, i * b, b).copy_(t)
        dist.all_reduce(out, group=g)
        return out

    def reduce_scatter(self, t: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """The sum over ``axes``' group of every rank's ``t``, this rank's
        block of it along ``dim`` (``t.shape[dim]`` split into ``size(axes)``
        equal blocks, in the order of ``index(axes)``): a new tensor.  Over
        NCCL ``reduce_scatter_tensor``; over gloo an ``all_reduce`` of a
        copy, then the rank's block."""
        g = self.group(axes)
        if g is None:
            return t.clone(memory_format=torch.contiguous_format)
        n, i = self.size(axes), self.index(axes)
        dim = dim % t.ndim
        if t.shape[dim] % n:
            raise ValueError(f"a dim of {t.shape[dim]} does not split over {n} ranks")
        b = t.shape[dim] // n
        if dist.get_backend(g) == "nccl":
            src = t.movedim(dim, 0).contiguous()
            out = src.new_empty((b,) + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(out, src, group=g)
            return out.movedim(0, dim).contiguous()
        full = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(full, group=g)
        return full.narrow(dim, i * b, b).contiguous()


REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class RecordingMesh(ProcessMesh):
    """A stand-in for a ``ProcessMesh`` of a production grid that holds one
    rank and no process group: "16x16" is (16, 16) over ("data", "model")
    and "2x16x16" (2, 16, 16) over ("pod", "data", "model"), the JAX
    package's axis names.  ``coords`` is the rank's coordinate on each
    axis (0 by default).  Its ``all_reduce`` returns its input unchanged,
    ``all_gather`` / ``reduce_scatter`` a tensor of their result's shape,
    and each records its bytes (the larger of operand and result, the
    JAX roofline's rule) by collective kind ("all-reduce" for a sum,
    "all-reduce-max", "all-gather", "reduce-scatter") and by the axes it
    ran over: what one rank's program sends, which the dry run reads
    where the JAX package parses its compiled HLO.  ``group`` returns a
    ``RecordedGroup`` of the axes, for the code that takes a group."""

    SHAPES = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 coords: Optional[Sequence[int]] = None):
        super().__init__(shape, axes)
        coords = tuple(coords) if coords is not None else (0,) * len(self.shape)
        if len(coords) != len(self.shape) or any(
                not 0 <= c < n for c, n in zip(coords, self.shape.values())):
            raise ValueError(f"coordinate {coords} is not on a {tuple(shape)} grid")
        self.coords = dict(zip(self.axis_names, coords))
        self.reset()

    @classmethod
    def named(cls, name: str, coords=None) -> "RecordingMesh":
        shape, axes = cls.SHAPES[name]
        return cls(shape, axes, coords)

    def reset(self):
        """Forget the recorded collectives."""
        self.bytes = {}      # (kind, "axis+axis") -> bytes
        self.calls = {}      # (kind, "axis+axis") -> calls

    def index(self, axes: Axes) -> int:
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes):
        axes = self._axes(axes)
        return None if self.size(axes) == 1 else RecordedGroup(self, axes)

    def _record(self, kind: str, axes, nbytes: int):
        key = (kind, "+".join(axes))
        self.bytes[key] = self.bytes.get(key, 0) + nbytes
        self.calls[key] = self.calls.get(key, 0) + 1

    def all_reduce(self, t: torch.Tensor, axes: Axes, op: str = "sum") -> torch.Tensor:
        axes = self._axes(axes)
        if op not in REDUCE_OPS:
            raise ValueError(f"no reduction {op!r}")
        if self.size(axes) > 1:
            self._record("all-reduce" if op == "sum" else f"all-reduce-{op}", axes,
                         t.numel() * t.element_size())
        return t

    def all_gather(self, t: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """A tensor of the gathered shape (this rank's ``t`` repeated),
        recorded as "all-gather" at the larger of operand and result, the
        result (the JAX roofline's rule)."""
        axes, n = self._axes(axes), self.size(axes)
        if n == 1:
            return t
        out = torch.cat([t] * n, dim=dim)
        self._record("all-gather", axes, out.numel() * out.element_size())
        return out

    def reduce_scatter(self, t: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim``, recorded as
        "reduce-scatter" at the larger of operand and result, the
        operand."""
        axes, n = self._axes(axes), self.size(axes)
        dim = dim % t.ndim
        if n == 1:
            return t.clone(memory_format=torch.contiguous_format)
        if t.shape[dim] % n:
            raise ValueError(f"a dim of {t.shape[dim]} does not split over {n} ranks")
        b = t.shape[dim] // n
        self._record("reduce-scatter", axes, t.numel() * t.element_size())
        return t.narrow(dim, self.index(axes) * b, b).clone(
            memory_format=torch.contiguous_format)

    def bytes_by_kind(self) -> dict:
        out = {}
        for (kind, _), n in self.bytes.items():
            out[kind] = out.get(kind, 0) + n
        return out

    def bytes_by_axes(self) -> dict:
        out = {}
        for (_, axes), n in self.bytes.items():
            out[axes] = out.get(axes, 0) + n
        return out


class RecordedGroup:
    """The group of ``axes`` of a ``RecordingMesh``: its size, this rank's
    index in it and its (recorded) ``all_reduce``."""

    def __init__(self, mesh: RecordingMesh, axes: Tuple[str, ...]):
        self.mesh, self.axes = mesh, axes

    def size(self) -> int:
        return self.mesh.size(self.axes)

    def rank(self) -> int:
        return self.mesh.index(self.axes)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.mesh.all_reduce(t, self.axes, op)


def make_mesh(shape, axes, device="cuda") -> ProcessMesh:
    """The grid of ``shape`` over every rank of the default process group
    (one process and no group: a grid of one rank), its ``DeviceMesh`` on
    ``device``'s type."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} grid needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    if not up:
        return ProcessMesh(shape, axes)
    return ProcessMesh(shape, axes, init_device_mesh(
        torch.device(device).type, shape, mesh_dim_names=axes))


def split_serving_devices(n_prefill: int, devices=None):
    """Disjoint prefill / decode device groups for disaggregated serving
    (paper §3): the last ``n_prefill`` devices (by default every card)
    go to the prefill cluster, the rest to decode.  Returns
    ``(prefill_devices, decode_devices)``.  ``n_prefill <= 0`` gives an
    empty prefill group (inline prefill); when ``n_prefill`` would leave
    decode empty (one card), both clusters share the whole pool."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_prefill <= 0:
        return [], devs
    if n_prefill < len(devs):
        return devs[-n_prefill:], devs[:-n_prefill]
    return devs, devs


class ServingRoles:
    """The disaggregated serving layout of ``world`` ranks (one rank is one
    device of the JAX package's meshes): the JAX rules of
    ``split_serving_devices`` and ``DisaggregatedInstance.__init__``
    applied to ranks.  ``prefill``: the last ``prefill_devices`` ranks
    (empty for inline prefill; every rank where they would leave decode
    empty, the overlapping fallback); ``attn``: the first ``max(1, n //
    2)`` of the other n ranks; ``expert``: the rest of them (the attention
    ranks where there are none).  ``attn_ranks`` / ``expert_ranks`` pin
    the two decode groups, as ``attn_devices`` / ``expert_devices`` do.
    With one decode rank both groups are that rank."""

    def __init__(self, world: int, prefill_devices: int = 0, *,
                 attn_ranks: Optional[Sequence[int]] = None,
                 expert_ranks: Optional[Sequence[int]] = None):
        if world < 1:
            raise ValueError(f"a layout of {world} ranks")
        self.world = world
        prefill, decode = split_serving_devices(prefill_devices, range(world))
        half = max(1, len(decode) // 2)
        self.prefill = tuple(prefill)
        self.decode = tuple(decode)
        self.attn = tuple(attn_ranks) if attn_ranks else tuple(decode[:half])
        self.expert = (tuple(expert_ranks) if expert_ranks
                       else tuple(decode[half:]) or tuple(decode[:1]))
        for name, g in (("attention", self.attn), ("expert", self.expert)):
            if not g or any(not 0 <= r < world for r in g) or len(set(g)) != len(g):
                raise ValueError(f"{name} ranks {g} of a world of {world}")
        if set(self.attn) & set(self.expert) and self.attn != self.expert:
            raise ValueError(f"attention ranks {self.attn} and expert ranks "
                             f"{self.expert} overlap")
        if attn_ranks or expert_ranks:
            self.decode = tuple(sorted(set(self.attn) | set(self.expert)))

    @property
    def disjoint(self) -> bool:
        """Attention and expert stages on separate ranks."""
        return not set(self.attn) & set(self.expert)

    @property
    def separate_prefill(self) -> bool:
        """A prefill cluster that shares no rank with decode."""
        return bool(self.prefill) and not set(self.prefill) & set(self.decode)

    def role(self, rank: int) -> str:
        """"attn", "expert", "attn+expert" (one decode rank), "prefill", or
        "idle" for a rank no group names."""
        if rank in self.attn and rank in self.expert:
            return "attn+expert"
        if rank in self.attn:
            return "attn"
        if rank in self.expert:
            return "expert"
        return "prefill" if rank in self.prefill else "idle"

    def __repr__(self):
        return (f"ServingRoles(world={self.world}, prefill={self.prefill}, "
                f"attn={self.attn}, expert={self.expert})")


class GroupMesh(ProcessMesh):
    """A one-axis grid over the ranks of a process group: ``axis`` has
    ``ranks`` in order, its collectives run in ``group`` (None in a
    process of its own).  Built on ranks outside the group too, where
    ``index`` is -1 and nothing may run over it."""

    def __init__(self, axis: str, ranks: Sequence[int], group=None):
        super().__init__((len(ranks),), (axis,))
        self.ranks = tuple(ranks)
        self._group = group
        me = dist.get_rank() if dist.is_initialized() else 0
        self._index = self.ranks.index(me) if me in self.ranks else -1

    def index(self, axes: Axes) -> int:
        self._axes(axes)
        return self._index

    def group(self, axes: Axes):
        self._axes(axes)
        return self._group if len(self.ranks) > 1 else None


def data_axes(mesh: ProcessMesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh: ProcessMesh) -> str:
    if "model" not in mesh.axis_names:
        raise ValueError(f"no 'model' axis in {mesh.axis_names}")
    return "model"
