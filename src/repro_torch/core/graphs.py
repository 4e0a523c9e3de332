"""CUDA graphs of the plain-PyTorch chains on the ping-pong decode's
attention stream (``core.disagg.DisaggregatedInstance.decode_microbatched``).

Between its hand-written kernels, one layer and micro-batch of the decode
issues tens of small PyTorch ops from the host, so the host, not the
card, sets the step.  Here each chain of plain PyTorch between two kernel
calls is captured once into a CUDA graph at the step's fixed shapes and
replayed every step, one launch where there were tens:

  * per layer and micro-batch: the attention prologue (``ln1``, the q / k
    / v products, both ropes, the K / V / pos writes into the ring at
    ``pos % W``), the attention epilogue (``wo``, the residual, ``ln2``)
    and the combine (the gate-weighted scatter-add, the dense extras, the
    post-norm, the residual);
  * once a step: the embedding, and the LM head.

Every kernel stays an eager call through ``kernels.ops`` each step
(``decode_attention``, ``gating_dispatch``, the ``grouped_matmul``
launches of ``grouped_mlp``), and so do the hops, the stage events and the
routing-count sum, so whatever wraps ``ops`` sees each launch as before;
``gating_dispatch`` still returns fresh tensors every call.  The dispatch
gather stays one eager ``index_select`` into a fresh buffer: a static one
would hold an (E, C, d) expert input per micro-batch for good (117 MB on
Arctic).

A replay reads and writes static buffers, one set per micro-batch that
every layer reuses: the eager path's live set, whose reuse the hops
already order (a micro-batch's buffers are written again only after its
combine, which waited for its expert stage).  ``decode_attention`` and
the expert MLP write their outputs into them (``out=``); the dispatch
table and gates are copied in.  All graphs share one private memory pool
and replay one after another on the attention stream.

``ChainCache`` decides how a step runs.  The chains are keyed on the
step's shapes (``DisaggregatedInstance.chain_spec``: the batch, the
micro-batch slices, the cache's dtype, the dispatch rows a placement
sets) and on the identity of the cache tensors, held by weak references:
the first step of a key runs eager (a warm-up), the next captures, the
later ones replay.  A cache made afresh every step, as the paged layout's
gathered view, never matches and always runs eager.
"""
from __future__ import annotations

import weakref
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import (attn_decode_epilogue,
                                            attn_decode_prologue, embed_tokens,
                                            lm_head)


class _Key:
    """A step's spec and its cache tensors, by weak reference."""

    def __init__(self, spec: tuple, tensors: Sequence[torch.Tensor]):
        self.spec = spec
        self.refs = [weakref.ref(t) for t in tensors]

    def matches(self, spec: tuple, tensors: Sequence[torch.Tensor]) -> bool:
        return (spec == self.spec and len(tensors) == len(self.refs)
                and all(r() is t for r, t in zip(self.refs, tensors)))


class ChainCache:
    """How each step runs: ``"eager"``, ``"capture"`` or ``"replay"``.
    ``chains`` holds the captured ``DecodeChains`` of one key at a time."""

    def __init__(self):
        self._warm: Optional[_Key] = None
        self._key: Optional[_Key] = None
        self.chains: Optional[DecodeChains] = None

    def action(self, spec: Optional[tuple], tensors: Sequence[torch.Tensor]) -> str:
        """The way the step of ``spec`` (None: a step that runs eager, and
        leaves the state as it was) over the cache ``tensors`` runs: a key
        met the step before is captured, a captured key replays, any other
        key becomes the one warmed up."""
        if spec is None:
            return "eager"
        if self._key is not None and self._key.matches(spec, tensors):
            return "replay"
        if self._warm is not None and self._warm.matches(spec, tensors):
            return "capture"
        self._warm = _Key(spec, tensors)
        return "eager"

    def install(self, chains: "DecodeChains"):
        """Keep ``chains``, captured for the warmed-up key, in place of any
        older ones."""
        self._key, self._warm, self.chains = self._warm, None, chains

    def drop(self):
        """Forget the captured chains (their buffers and graphs free)."""
        self._key = self.chains = None


def cuda_capture(device):
    """``capture(fn, *args)``: a CUDA graph of the work ``fn(*args)``
    issues (nothing runs until its ``replay()``).  Every graph it makes
    shares one private memory pool and one capture stream."""
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream(device)

    def capture(fn, *args):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool, stream=stream):
            fn(*args)
        return g
    return capture


class DecodeChains:
    """The captured chains of one ``DisaggregatedInstance`` at one key,
    their static buffers, and the stage functions the decode loop calls
    in place of the eager ones."""

    def __init__(self, rt, cache: List[dict], mbs: Sequence[slice], batch: int,
                 rows: int):
        """``rt``: the runtime; ``cache``: its per-layer KV; ``mbs``: the
        micro-batch slices; ``rows``: the dispatch table's rows (0 for a
        dense FFN).  Allocates the static buffers and captures every
        chain (nothing runs until a replay)."""
        cfg, dev, dt = rt.cfg, rt.device, rt.dtype
        # by weak reference: the runtime holds these chains, and a cycle
        # would keep the model's weights alive until a collection
        self.rt, self.mbs = weakref.proxy(rt), list(mbs)
        H, hd, d = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model
        sizes = [s.stop - s.start for s in self.mbs]
        zeros = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype, device=dev)
        self.tokens = zeros(batch, dtype=torch.int64)
        self.pos = zeros(batch, dtype=torch.int32)
        self.act = torch.ones(batch, dtype=torch.float32, device=dev)
        self.pos_mb = [self.pos[s] for s in self.mbs]
        self.act_mb = [self.act[s] for s in self.mbs]
        self.x = [zeros(t, d) for t in sizes]           # the residual stream
        self.xm = [zeros(t, d) for t in sizes]          # after attention
        # ln2's output; the last row stays zero: the gather's sentinel row
        self.h_pad = [zeros(t + 1, d) for t in sizes]
        self.h = [h[:-1] for h in self.h_pad]
        self.q = [zeros(t, H, hd) for t in sizes]
        self.att = [zeros(t, H, hd) for t in sizes]
        if cfg.moe is not None:
            caps = [moe_lib.expert_capacity(t, cfg.moe, rt.plan.capacity_mode)
                    for t in sizes]
            self.idx = [torch.full((rows, c), t, dtype=torch.int32, device=dev)
                        for t, c in zip(sizes, caps)]
            self.idx_flat = [i.view(-1) for i in self.idx]
            self.gates = [zeros(rows, c, dtype=torch.float32) for c in caps]
            self.out = [zeros(rows, c, d) for c in caps]
        else:
            self.out = [zeros(t, d) for t in sizes]
        self.entries = [[{k: v[s] for k, v in entry.items()} for s in self.mbs]
                        for entry in cache]
        self.logits: Optional[torch.Tensor] = None
        self._capture()

    # ------------------------------------------------------------ capture
    def _capture(self):
        capture = cuda_capture(self.rt.device)
        m = len(self.mbs)
        self.embed_graph = capture(self._embed)
        self.layer_graphs = [[tuple(capture(fn, l, i) for fn in
                                    (self._prologue, self._epilogue, self._combine))
                              for i in range(m)]
                             for l in range(len(self.entries))]
        self.head_graph = capture(self._head)

    def _embed(self):
        rt = self.rt
        for x, s in zip(self.x, self.mbs):
            x.copy_(embed_tokens(rt.head, rt.cfg, self.tokens[s]))

    def _prologue(self, l: int, i: int):
        rt = self.rt
        self.q[i].copy_(attn_decode_prologue(rt.layers_attn[l], rt.cfg, self.x[i],
                                             self.pos_mb[i], self.entries[l][i]))

    def _epilogue(self, l: int, i: int):
        p = self.rt.layers_attn[l]
        torch.add(self.x[i], attn_decode_epilogue(p, self.rt.cfg, self.att[i]),
                  out=self.xm[i])
        self.h[i].copy_(rms_norm(self.xm[i], p["ln2"]))

    def _combine(self, l: int, i: int):
        disp = ({"idx": self.idx[i], "gates": self.gates[i]}
                if self.rt.cfg.moe is not None else None)
        self.x[i].copy_(self.rt._combine_phase(self.rt.layers_attn[l], self.xm[i],
                                               self.h[i], self.out[i], disp))

    def _head(self):
        self.logits = torch.cat([lm_head(self.rt.head, self.rt.cfg, x)
                                 for x in self.x], 0)

    # ------------------------------------------------------------- replay
    def begin(self, tokens, pos, active: Optional[torch.Tensor]):
        """The step's inputs into their static buffers, then the
        embedding."""
        self.tokens.copy_(tokens)
        self.pos.copy_(pos)
        if active is None:
            self.act.fill_(1.0)
        else:
            self.act.copy_(active)
        self.embed_graph.replay()

    def attn(self, l: int, i: int, window: int, tbl):
        """The attention stage of micro-batch i in layer l, as
        ``DisaggregatedInstance._attn_phase``: (x, h, the dispatch or
        None), x and h static; the dispatch adds ``out``, the static
        buffer the expert MLP writes into."""
        rt = self.rt
        pro, epi, _ = self.layer_graphs[l][i]
        entry = self.entries[l][i]
        pro.replay()
        kops.decode_attention(self.q[i], entry["k"], entry["v"], entry["pos"],
                              self.pos_mb[i], window=window,
                              attn_softcap=rt.cfg.attn_softcap, out=self.att[i])
        epi.replay()
        rt.graphed_n += 1
        if rt.cfg.moe is None:
            return self.xm[i], self.h[i], None
        idx, gates, counts = rt._route(rt.layers_attn[l], self.h[i],
                                       self.act_mb[i], tbl)
        self.idx[i].copy_(idx)
        self.gates[i].copy_(gates)
        xe = torch.index_select(self.h_pad[i], 0, self.idx_flat[i])
        return self.xm[i], self.h[i], {
            "xe": xe.view(self.out[i].shape), "idx": self.idx[i],
            "gates": self.gates[i], "counts": counts, "out": self.out[i]}

    def combine(self, l: int, i: int, out: torch.Tensor):
        """The combine of micro-batch i in layer l; ``out`` is the expert
        stage's output (a dense FFN's is copied into the static buffer,
        the expert MLP wrote into it already)."""
        if out is not self.out[i]:
            self.out[i].copy_(out)
        self.layer_graphs[l][i][2].replay()
        self.rt.graphed_n += 1

    def head(self) -> torch.Tensor:
        """The step's logits (B, V): a copy, since the graph's own output
        lies in the pool the other chains reuse."""
        self.head_graph.replay()
        return self.logits.clone()
