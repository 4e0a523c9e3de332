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

Sequence parallelism (``ModelParallel(..., seq_parallel=True)``, the
JAX dry run's ``ACT_SPEC = P(data, "model", None)``): between the
layers of the stacked block periods (``transformer._seq_pass``; not the
remainder layers, the encoder or a decode step, which JAX's constraint
never reaches) a rank holds its block of the sequence, in blocks of
ceil(T / m) rows as ``with_sharding_constraint`` pads a dim that m does
not divide.  The residual, the norms (their scales entered: each rank
sees only its rows) and the post-norms and gates run on the block.
Each sublayer gathers its normed input (``seq_full``: all-gather
forward, a reduce-scatter backward, where the uses of the rank's
partial gradient enter through ``enter_seq`` in place of ``enter``'s
``all_reduce``) and runs as without the flag on the whole sequence;
its tensor-parallel sum becomes
``reduce_act``, a reduce-scatter over the sequence forward and an
all-gather backward, and an output the rules left whole is cut to the
block (``seq_block``: the block forward, an all-gather backward).  The
router runs on the gathered rows, every model rank alike.

Over the data axes (``training.loop.make_train_step`` under fsdp,
ep2d, ZeRO-1 or m2n; the JAX dry run's train records) the data ranks
hold different rows and the step averages their gradients, so these
operators differentiate the sum of the data ranks' losses:
``gather_data`` (all-gather forward, reduce-scatter backward: an FSDP /
ep2d leaf at its use), ``from_owner`` (a leaf held whole by one data
rank, the one that holds its JAX block: its copy summed with the others'
zeros forward, the gradient summed to it backward) and ``sum_data``
(a sum forward and backward: m2n2d's f-partials, the m2n aux's mean).
``gathering(layout)`` installs the hook the model code calls on each
layer's params (``use_params``), inside the remat recompute too.
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
    """Sum over ``axes`` of the mesh ("model" by default) forward,
    identity backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes="model"):
        t = t.clone(memory_format=torch.contiguous_format)
        return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Identity forward, sum over ``axes`` of the mesh ("model" by
    default) backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes="model"):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


def reduce_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``ModelParallel.reduce`` over any ``axes`` of ``mesh`` whose ranks
    share one loss (m2n's expert axis)."""
    return _Reduce.apply(t, mesh, axes) if mesh.size(axes) > 1 else t


def enter_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``ModelParallel.enter`` over any ``axes`` of ``mesh``."""
    return _Enter.apply(t, mesh, axes) if mesh.size(axes) > 1 else t


def _block_rows(T: int, m: int, i: int):
    """(rows per block b = ceil(T / m), this rank's first and end row)
    of a dim of T cut into m blocks padded as ``with_sharding_constraint``
    pads a dim that m does not divide (the last ranks hold fewer rows,
    possibly none)."""
    b = -(-T // m)
    lo = min(T, i * b)
    return b, lo, min(T, lo + b)


def _pad_to(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` padded with zeros along ``dim`` to ``n`` entries."""
    extra = n - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


class _Gather(torch.autograd.Function):
    """All-gather over ``axes`` along ``dim`` forward, reduce-scatter
    backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(t.contiguous(), axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g.contiguous(), ctx.axes, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter over ``axes`` along ``dim`` forward, all-gather
    backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.reduce_scatter(t.contiguous(), axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.axes, ctx.dim), None, None, None


class _GatherMean(torch.autograd.Function):
    """All-gather over ``axes`` along ``dim`` forward; backward the
    reduce-scatter of the ranks' gradients divided by their number: the
    rank's block of a gradient that is the same on every rank, or of the
    sum of partial gradients each scaled by it (``_Scale``)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(t.contiguous(), axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.reduce_scatter(g.contiguous(), ctx.axes, ctx.dim)
        return g.div_(ctx.mesh.size(ctx.axes)), None, None, None


class _Scale(torch.autograd.Function):
    """Identity forward, the gradient times ``n`` backward."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


class _Split(torch.autograd.Function):
    """The rank's block along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        b = t.shape[dim] // mesh.size(axes)
        return t.narrow(dim, mesh.index(axes) * b, b).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.axes, ctx.dim), None, None, None


class _Sum(torch.autograd.Function):
    """Sum over ``axes`` forward and backward: the gradient of the sum of
    every rank's loss."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(t.clone(memory_format=torch.contiguous_format), axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format),
                                   ctx.axes), None, None


class _FromOwner(torch.autograd.Function):
    """The whole leaf held by the rank of ``axes`` at ``owner`` (the others
    hold an empty tensor) on every rank forward (its copy summed with the
    others' zeros), the gradient summed to it backward."""

    @staticmethod
    def forward(ctx, held, mesh, axes, owner, shape):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.mine = mesh.index(axes) == owner
        t = (held.clone(memory_format=torch.contiguous_format) if ctx.mine
             else held.new_zeros(shape))
        return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.axes)
        return (g if ctx.mine else g.new_zeros((0,))), None, None, None, None


def gather_data(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The whole of a leaf split over the data ``axes`` along ``dim``:
    all-gather forward, reduce-scatter backward."""
    return _Gather.apply(t, mesh, tuple(axes), dim % t.ndim)


def from_owner(held: torch.Tensor, mesh, axes, owner: int, shape) -> torch.Tensor:
    """The leaf that the rank at ``owner`` of ``axes`` holds whole (an
    empty ``held`` elsewhere) on every rank of them; its gradient summed
    to the owner."""
    return _FromOwner.apply(held, mesh, tuple(axes), owner, tuple(shape))


def sum_data(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of every rank's ``t``; backward the sum of
    their gradients."""
    axes = tuple(axes)
    return _Sum.apply(t, mesh, axes) if axes and mesh.size(axes) > 1 else t


_GATHER = None


@contextlib.contextmanager
def gathering(layout):
    """Hand every ``use_params`` call within the block to ``layout.use``
    (a ``launch.sharding.Layout``: each leaf a rank holds split over the
    data axes, or whole on one of them, made whole at its use)."""
    global _GATHER
    prev, _GATHER = _GATHER, layout
    try:
        yield layout
    finally:
        _GATHER = prev


def use_params(tree: dict, prefix: str) -> dict:
    """The leaves of ``tree`` (the params dict at ``prefix``: "" for the top
    level, "layers/3", "encoder", "encoder/layers/0") as the model code
    reads them: the installed layout's whole leaves at their use, or
    ``tree`` itself.  Nested dicts and lists are left to their own
    call."""
    return tree if _GATHER is None else _GATHER.use(tree, prefix)


class ModelParallel:
    """This rank's place on the "model" axis of ``mesh`` and the
    collectives over it, every one through ``mesh.all_reduce`` (which the
    dry run's ``launch.mesh.RecordingMesh`` records).

    ``batch``: the global batch of a serving pass (``prefill`` /
    ``decode_step``), which decides the KV cache's layout under
    ``launch.sharding.cache_entry_specs``; None reads it as the rank's
    rows times the data axes' size (the rows cut over them, as
    ``sharding.input_spec`` cuts a batch they divide)."""

    def __init__(self, mesh, batch: Optional[int] = None,
                 seq_parallel: bool = False):
        self.mesh = mesh
        self.size = mesh.size("model")
        self.index = mesh.index("model")
        self.batch = batch
        self.seq_parallel = seq_parallel and self.size > 1
        self.sp = None          # (rows, T) inside a sequence-parallel region

    # -- sequence parallelism ----------------------------------------------

    @contextlib.contextmanager
    def seq_region(self, rows: int, T: int):
        """Within the block, activations of ``rows`` x ``T`` tokens are held
        as this rank's block of the sequence (a no-op without
        ``seq_parallel``)."""
        prev = self.sp
        self.sp = (rows, T) if self.seq_parallel else None
        try:
            yield self
        finally:
            self.sp = prev

    def _seq_view(self, t: torch.Tensor):
        """``t`` with the sequence on dim 1: (B, T, ...) as it is, a flat
        (B * T, ...) token batch reshaped; and the function that undoes
        it."""
        if t.ndim >= 3:
            return t, lambda u: u
        rows = self.sp[0]
        return (t.reshape((rows, -1) + tuple(t.shape[1:])),
                lambda u: u.reshape((-1,) + tuple(u.shape[2:])))

    def _seq_op(self, t: torch.Tensor, fn, gather: bool) -> torch.Tensor:
        T = self.sp[1]
        b, lo, hi = _block_rows(T, self.size, self.index)
        v, back = self._seq_view(t)
        if gather:
            out = fn.apply(_pad_to(v, 1, b), self.mesh, ("model",), 1)
            return back(out.narrow(1, 0, T))
        out = fn.apply(_pad_to(v, 1, b * self.size), self.mesh, ("model",), 1)
        return back(out.narrow(1, 0, hi - lo))

    def seq_full(self, t: torch.Tensor) -> torch.Tensor:
        """Inside a sequence-parallel region, the whole sequence of this
        rank's block ``t`` (all-gather forward; backward the reduce-scatter
        of the ranks' gradients over m: a use whose gradient is the same
        on every rank, such as the router's, counts once, and a use whose
        gradient is a rank's partial enters through ``enter_seq``); else
        ``t``."""
        return t if self.sp is None else self._seq_op(t, _GatherMean, True)

    def enter_seq(self, x: torch.Tensor) -> torch.Tensor:
        """``enter`` of a sublayer's input ``x`` (``seq_full``'s output) for
        a use whose gradient is the rank's partial (its heads, its d_ff
        block, its experts).  Inside a sequence-parallel region the
        partials are summed by ``seq_full``'s reduce-scatter, which
        divides by m: the gradient is scaled by m here, and no
        ``all_reduce`` is made."""
        if self.sp is None:
            return self.enter(x)
        return _Scale.apply(x, self.size)

    def seq_block(self, t: torch.Tensor) -> torch.Tensor:
        """Inside a sequence-parallel region, this rank's block of the whole
        (replicated) sequence ``t`` (all-gather backward); else ``t``."""
        return t if self.sp is None else self._seq_op(t, _Split, False)

    def reduce_act(self, t: torch.Tensor) -> torch.Tensor:
        """``reduce`` of a rank's partial activation: inside a
        sequence-parallel region a reduce-scatter over the sequence (the
        rank's block of the sum; all-gather backward)."""
        if self.sp is None:
            return self.reduce(t)
        return self._seq_op(t, _Scatter, False)

    def seq_weight(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated weight used on this rank's block of the sequence
        (a norm scale, a gate): entered inside a sequence-parallel region,
        where each rank's gradient holds only its rows' share."""
        return w if self.sp is None else self.enter(w)

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


def seq_full(t: torch.Tensor) -> torch.Tensor:
    """``ModelParallel.seq_full`` of the installed model axis (``t`` where
    there is none)."""
    return t if _ACTIVE is None else _ACTIVE.seq_full(t)


def seq_block(t: torch.Tensor) -> torch.Tensor:
    """``ModelParallel.seq_block`` of the installed model axis."""
    return t if _ACTIVE is None else _ACTIVE.seq_block(t)


def seq_weight(w: torch.Tensor) -> torch.Tensor:
    """``ModelParallel.seq_weight`` of the installed model axis."""
    return w if _ACTIVE is None else _ACTIVE.seq_weight(w)


def check_kinds(kinds) -> None:
    """Raise for a layer kind without a model axis."""
    for kind in kinds:
        if kind not in KINDS:
            raise NotImplementedError(
                f"the {kind!r} layer kind has no model axis in the port yet; "
                f"run it with a model axis of 1")
