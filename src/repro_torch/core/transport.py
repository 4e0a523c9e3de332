"""Pluggable transport layer (paper §4.2) of the port, on one card.

Every hop of the serving path goes through one ``Transport`` with per-
kind bytes and latency accounting, as in the JAX package's
``core/transport.py``.  On one card the attention stage, the expert
stage and the prefill worker run on CUDA streams of the same device, so
a hop moves no bytes: the destination stream waits on an event recorded
on the source (with ``sync`` the host waits on it too), and the tensors
that cross are marked with ``record_stream``, so the caching allocator
keeps their memory until the destination is done with them.  The
ledger still counts what the hop would carry between nodes (payload
bytes times the fan-out), the same numbers the JAX package records.

  * ``InProcessTransport`` — the stream hop, accounted.
  * ``SimRdmaTransport`` — the same hop plus an alpha-beta RDMA cost
    model per hop (``RdmaCostModel``).

The multi-process backend (``MultiControllerTransport`` of the JAX
package) needs more than one process and card; ``make_transport("multi")``
raises until the multi-process slice of the port brings it.

Hop kinds:

  ``tokens``      M2N dispatch / N2M return of token activations
  ``kv``          prefill->decode KV migration (a row or one page a hop)
  ``weights``     expert-weight regathers (live placement)
  ``collective``  the m2n combine, accounted analytically
"""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

HOP_KINDS = ("tokens", "kv", "weights", "collective")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def tree_nbytes(tree) -> int:
    """Total payload bytes of a nest of dicts / lists / tuples of tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


@dataclass
class TransportHandle:
    """One hop.  ``data`` is the handed-over nest of tensors (the same
    tensors: nothing is copied on one card).  ``nbytes`` is the wire-byte
    model of the hop: payload bytes times the fan-out.  ``issue_s`` is
    host time spent issuing; ``sim_s`` the simulated wire latency (0 for
    ``InProcessTransport``)."""
    kind: str
    nbytes: int
    issue_s: float
    sim_s: float = 0.0
    fanout: int = 1
    data: Any = None


def _empty_stats() -> dict:
    return {k: {"hops": 0, "bytes": 0, "issue_s": 0.0, "sim_s": 0.0}
            for k in HOP_KINDS}


class Transport(abc.ABC):
    """Hops of token activations, KV rows or pages and weight
    regathers, accounted per kind in ``stats()``; the serving engine
    reports the snapshot in ``Engine.stats()["transport"]``."""

    name = "abstract"

    def __init__(self):
        self._stats = _empty_stats()

    @abc.abstractmethod
    def send(self, tree, dst=None, *, src=None, kind: str = "tokens",
             sync: bool = False, fanout: int = 1) -> TransportHandle:
        """Hand ``tree`` from stream ``src`` to stream ``dst`` (both None
        on the CPU, or for a hop that only needs accounting); ``sync``
        makes the host wait until ``src`` has made ``tree``; ``fanout``
        is the number of peers receiving a copy."""

    def send_tokens(self, x, dst=None, *, src=None,
                    fanout: int = 1) -> TransportHandle:
        """M2N dispatch / N2M return hop of token activations."""
        return self.send(x, dst, src=src, kind="tokens", fanout=fanout)

    def migrate_kv(self, request_kv, dst=None, *, src=None,
                   sync: bool = False) -> TransportHandle:
        """Prefill->decode KV hop: one request's cache rows."""
        return self.send(request_kv, dst, src=src, kind="kv", sync=sync)

    def migrate_pages(self, page_chunk, dst=None, *, src=None,
                      sync: bool = False) -> TransportHandle:
        """Page-granular prefill->decode KV hop: one page's worth of
        cache across all layers.  Same kind as ``migrate_kv``, so the
        ledger counts one "kv" hop per page moved."""
        return self.send(page_chunk, dst, src=src, kind="kv", sync=sync)

    def regather_weights(self, tree, dst=None, *, src=None,
                         fanout: int = 1) -> TransportHandle:
        """Expert-weight regather (live placement)."""
        return self.send(tree, dst, src=src, kind="weights", fanout=fanout)

    def record_collective(self, nbytes: int, *,
                          fanout: int = 1) -> TransportHandle:
        """Account a collective hop (the m2n combine) whose wire bytes
        are known in closed form.  No data moves here."""
        h = TransportHandle(kind="collective", nbytes=int(nbytes),
                            issue_s=0.0, fanout=fanout)
        h.sim_s = self._simulate(h)
        self._account(h)
        return h

    # ------------------------------------------------------------- accounting
    def _simulate(self, handle: TransportHandle) -> float:
        return 0.0

    def _account(self, handle: TransportHandle):
        s = self._stats[handle.kind]
        s["hops"] += 1
        s["bytes"] += handle.nbytes
        s["issue_s"] += handle.issue_s
        s["sim_s"] += handle.sim_s

    def stats(self) -> dict:
        """Per-kind cumulative hop counters plus the backend name."""
        out = {"backend": self.name}
        for k, s in self._stats.items():
            if s["hops"]:
                out[k] = dict(s)
        return out

    def reset_stats(self):
        self._stats = _empty_stats()


class InProcessTransport(Transport):
    """One process, one card: a hop is a stream hand-over."""

    name = "inproc"

    def send(self, tree, dst=None, *, src=None, kind: str = "tokens",
             sync: bool = False, fanout: int = 1) -> TransportHandle:
        t0 = time.perf_counter()
        if dst is not None:
            ready = src.record_event()
            dst.wait_event(ready)
            for t in _leaves(tree):
                t.record_stream(dst)
            if sync:
                ready.synchronize()
        h = TransportHandle(kind=kind,
                            nbytes=tree_nbytes(tree) * max(1, fanout),
                            issue_s=time.perf_counter() - t0,
                            fanout=fanout, data=tree)
        h.sim_s = self._simulate(h)
        self._account(h)
        return h


# --------------------------------------------------------------- cost model
@dataclass(frozen=True)
class RdmaCostModel:
    """Alpha-beta network model for one-to-N transfers (paper §5
    fig10/11): ``alpha_s`` per batch of ``group`` peer ops, ``per_op_s``
    per peer, ``bw_Bps`` the link rate, ``jitter_p99_s`` the per-batch
    tail jitter and ``tail_floor_s`` a flat tail."""
    alpha_s: float
    per_op_s: float
    bw_Bps: float
    group: int = 1
    jitter_p99_s: float = 0.0
    tail_floor_s: float = 0.0

    def one_to_n(self, size_bytes: int, n: int) -> float:
        """Median latency of one sender writing ``size_bytes`` to each
        of ``n`` receivers."""
        batches = -(-n // self.group)
        return (batches * self.alpha_s + n * self.per_op_s
                + n * size_bytes / self.bw_Bps)

    def p99_one_to_n(self, size_bytes: int, n: int) -> float:
        batches = -(-n // self.group)
        return (self.one_to_n(size_bytes, n)
                + batches * self.jitter_p99_s + self.tail_floor_s)

    @classmethod
    def nccl_grouped_p2p(cls) -> "RdmaCostModel":
        """NCCL-like grouped peer-to-peer (the paper's §5 constants,
        200 Gbps NIC)."""
        return cls(alpha_s=40e-6, per_op_s=15e-6, bw_Bps=25e9, group=8,
                   jitter_p99_s=120e-6)

    @classmethod
    def m2n_rdma(cls) -> "RdmaCostModel":
        """The paper's M2N library: one pre-registered RDMA write per
        peer, no staging, flat tail."""
        return cls(alpha_s=6e-6, per_op_s=1e-6, bw_Bps=25e9, group=10 ** 9,
                   jitter_p99_s=0.0, tail_floor_s=8e-6)


class SimRdmaTransport(InProcessTransport):
    """The stream hop plus a simulated RDMA latency per hop from an
    ``RdmaCostModel``; ``default_fanout`` is the peer count assumed for
    hops that give none."""

    name = "simrdma"

    def __init__(self, model: Optional[RdmaCostModel] = None, *,
                 default_fanout: int = 1):
        super().__init__()
        self.model = model if model is not None else RdmaCostModel.m2n_rdma()
        self.default_fanout = max(1, default_fanout)

    def _simulate(self, handle: TransportHandle) -> float:
        n = max(1, handle.fanout if handle.fanout > 1 else self.default_fanout)
        return self.model.one_to_n(handle.nbytes // max(1, n), n)


TRANSPORTS = {"inproc": InProcessTransport, "simrdma": SimRdmaTransport}


def make_transport(name: str, **kwargs) -> Transport:
    """Instantiate a backend by name ('inproc' | 'simrdma')."""
    if name == "multi":
        raise NotImplementedError(
            "the multi-controller transport needs several processes and "
            "cards; it comes with the port's multi-process slice")
    try:
        cls = TRANSPORTS[name]
    except KeyError:
        raise ValueError(f"unknown transport {name!r}; "
                         f"choose from {sorted(TRANSPORTS)}") from None
    return cls(**kwargs)
