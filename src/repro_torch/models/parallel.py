"""Tensor and expert parallelism over the "model" axis of a process grid
(``launch.mesh.ProcessMesh``): each rank holds its block of every
sharded leaf (``launch.sharding.local_shard`` under the JAX rules) and
the model code runs the collectives itself, where the JAX package lets
GSPMD insert them.

Installed with ``ModelParallel(mesh).install()`` (as
``moe.set_routed_impl`` installs a routed impl), the model code reads
``current()`` and, in each sublayer whose weights are split:

  * attention: column-parallel ``wq`` / ``wk`` / ``wv`` over contiguous
    heads, row-parallel ``wo``, then a sum over "model";
  * dense FFN, shared experts, dense residual: ``w1`` / ``w3`` columns,
    ``w2`` rows, then a sum;
  * routed experts: each rank runs its E / m experts (EP) or every
    expert on its d_ff slice (the fallback where E does not divide),
    then a sum; the dispatch is the replicated routing's;
  * embedding and LM head: the vocabulary split; each rank looks up the
    ids of its rows (0 elsewhere) and the log-softmax combines each
    rank's logsumexp.

A sublayer whose weights the rules left whole runs as in one process.

Autograd.  Every rank computes the same replicated activations and the
same loss, and differentiates that one loss; the rank-local regions
(a rank's heads, experts or vocabulary rows) are entered and left
through two conjugate operators (Megatron's f and g):

  * ``enter``: identity forward, sum over "model" backward.  A
    replicated tensor that enters a rank's region (the normed
    activation before a column-parallel weight, the routing gates before
    the combine, a replicated weight used by the rank's heads) gets from
    each rank only its region's share of the gradient; the sum makes it
    the whole gradient on every rank, so a replicated leaf's gradient
    is the same on every model rank.
  * ``reduce``: sum over "model" forward, identity backward.  A
    rank's partial result (after ``wo`` / ``w2`` / the expert combine /
    the embedding lookup) becomes the replicated sum; the gradient of the
    sum is the same on every rank and is each partial's gradient.
    ``torch.distributed.nn.functional.all_reduce`` sums again in
    backward, which would count each rank's gradient m times here.

Two compositions recur.  A rank's block that the next op needs whole
(RG-LRU's conv output before the gate matrices, split by column only;
SSD's projection and conv output, whose blocks straddle the
``[z | x | B | C | dt]`` segments) is gathered and then entered:
``enter_gather``.  A statistic over a dim split across the ranks (the
sum of squares of SSD's gated RMSNorm over all of d_inner) is summed
and then entered: ``enter_sum``.  ``reduce`` alone would hand each rank
only its own block's share of the gradient.

Under remat the non-reentrant checkpoint re-runs a block period's
forward, collectives included, in backward: every rank reaches them in
the same order because every rank builds the same graph.  Every layer
kind of ``config.LAYER_KINDS`` has a model axis (``KINDS``):

  * ``attn`` / ``local`` / the self half of ``selfcross``: as above.
    Query heads that do not split over the axis (24 on 16 ranks: the
    rule cuts ``wq``'s columns mid-head) are all computed on every rank
    from the gathered, entered weight, and the rank keeps its block of
    the flattened head columns before its rows of ``wo``;
  * ``cross`` / the cross half of ``selfcross``: q from the rank's
    columns, K / V of the source from the rank's kv heads (or every kv
    head, the split weight gathered), ``wo``'s rows, a sum;
  * ``rglru``: the rank's block of the recurrence width; the gates read
    every channel of the conv output (``enter_gather``);
  * ``ssd``: the rank's heads, with the whole B and C (one group) and a
    cross-rank RMSNorm.

Serving (``prefill``, ``decode_step``) holds each layer's cache in the
rank's block under ``launch.sharding.cache_entry_specs``.  A KV ring or
a cross source (``k_src`` / ``v_src``) holds the rank's kv heads where
they split over "model", else every kv head on its block of the slots
(``kv_spec``), or the whole source where its length does not divide.
With slots split the ranks' partial softmax rows are merged by
``merge_partials``.  The recurrent states ``h`` / ``ssm`` and the conv
windows hold the rank's channels or heads.
"""
from __future__ import annotations

import contextlib
import types
from typing import Optional

import torch

_ACTIVE: Optional["ModelParallel"] = None

# the layer kinds that run with a model axis above 1 (every kind of
# ``config.LAYER_KINDS``; ``check_kinds`` refuses a kind added later)
KINDS = ("attn", "local", "cross", "selfcross", "rglru", "ssd")


def current() -> Optional["ModelParallel"]:
    """The installed model-parallel context, or None (one process, or a
    model axis of one rank)."""
    return _ACTIVE


class _Reduce(torch.autograd.Function):
    """Sum over the "model" axis of the mesh forward, identity backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        t = t.clone(memory_format=torch.contiguous_format)
        return mesh.all_reduce(t, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Identity forward, sum over the "model" axis of the mesh backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(g, "model"), None


class ModelParallel:
    """This rank's place on the "model" axis of ``mesh`` and the
    collectives over it, every one through ``mesh.all_reduce`` (which the
    dry run's ``launch.mesh.RecordingMesh`` records).

    ``batch``: the global batch of a serving pass (``prefill`` /
    ``decode_step``), which decides the KV cache's layout under
    ``launch.sharding.cache_entry_specs``; None reads it as the rank's
    rows times the data axes' size (the rows cut over them, as
    ``sharding.input_spec`` cuts a batch they divide)."""

    def __init__(self, mesh, batch: Optional[int] = None):
        self.mesh = mesh
        self.size = mesh.size("model")
        self.index = mesh.index("model")
        self.batch = batch

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(t, self.mesh) if self.size > 1 else t

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(t, self.mesh) if self.size > 1 else t

    def enter_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``gather`` of the rank's block, entered: the whole tensor for a
        use inside the rank's region, whose gradient (partial on each rank)
        is summed before each rank takes its block's."""
        return self.enter(self.gather(t, dim))

    def enter_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over "model" of each rank's ``t``, entered: a statistic
        over a split dim used inside the ranks' regions."""
        return self.enter(self.reduce(t))

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order,
        replicated: each rank's block in a zero-filled tensor, summed (gloo
        has no CUDA ``all_gather``).  Backward hands each rank its block of
        the (replicated) gradient."""
        dim = dim % t.ndim
        parts = [t if r == self.index else torch.zeros_like(t)
                 for r in range(self.size)]
        return self.reduce(torch.cat(parts, dim=dim))

    def block(self, full: int, local: int) -> Optional[slice]:
        """This rank's slice of a dim of ``full`` entries split into blocks
        of ``local``, or None where the dim is whole."""
        if local == full:
            return None
        if local * self.size != full:
            raise ValueError(f"a dim of {full} held as {local} on {self.size} ranks")
        return slice(self.index * local, (self.index + 1) * local)

    def kv_spec(self, rows: int, W: int, n_kv: int, hd: int):
        """The ``launch.sharding.Spec`` of a (B, W, Hkv, hd) K / V ring
        under ``cache_entry_specs`` for a pass of ``rows`` local rows:
        (batch axes, slot axes, kv-head axis, None)."""
        from repro_torch.launch import sharding
        from repro_torch.launch.mesh import data_axes
        batch = self.batch if self.batch is not None else \
            rows * self.mesh.size(data_axes(self.mesh))
        # the rule reads shapes only
        entry = {"k": types.SimpleNamespace(shape=(batch, W, n_kv, hd))}
        return sharding.cache_entry_specs(entry, self.mesh, batch)["k"]

    def merge_partials(self, out: torch.Tensor, lse: torch.Tensor,
                       axes="model") -> torch.Tensor:
        """The flash-decoding merge of each rank's attention row over its
        block of the ring's slots: ``out`` (B, H, hd) f32 and ``lse`` (B, H)
        f32 from ``decode_attention(partial=True)``, or (B, Sq, H, hd) and
        (B, Sq, H) from ``attention.cross_attention_partial`` over a block
        of a cross source's slots.  A ``MAX``
        ``all_reduce`` of lse gives the shift M, then one ``SUM`` of
        exp(lse - M) * out beside exp(lse - M) gives the row over every
        rank's slots, in ``out``'s shape, f32.  A row that no rank holds a valid
        slot of (lse -inf everywhere) comes out 0.  Serving runs no
        autograd, so there is no conjugate operator here (the values are
        merged as plain tensors)."""
        M = self.mesh.all_reduce(lse.clone(), axes, "max")
        w = torch.exp(lse - torch.where(torch.isfinite(M), M, 0.0))      # 0 at -inf
        both = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
        both = self.mesh.all_reduce(both.contiguous(), axes)
        den = both[..., -1:]
        return both[..., :-1] / torch.where(den > 0, den, 1.0)

    @contextlib.contextmanager
    def install(self):
        """Run the model code of this block on this rank's shards."""
        global _ACTIVE
        prev, _ACTIVE = _ACTIVE, self
        try:
            yield self
        finally:
            _ACTIVE = prev


def check_kinds(kinds) -> None:
    """Raise for a layer kind without a model axis."""
    for kind in kinds:
        if kind not in KINDS:
            raise NotImplementedError(
                f"the {kind!r} layer kind has no model axis in the port yet; "
                f"run it with a model axis of 1")
