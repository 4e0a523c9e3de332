"""Pluggable transport layer (paper §4.2) of the port.

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
  * ``MultiControllerTransport`` — ``torch.distributed`` bring-up over
    several processes (explicit ``DistributedSpec``, or env:
    ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``,
    with the OpenMPI and SLURM rank variables as fallbacks).  Gloo where
    the ranks run on the CPU or share a card, NCCL where each rank has a
    card of its own.  In one process it is the in-process hop.

Hop kinds:

  ``tokens``      M2N dispatch / N2M return of token activations
  ``kv``          prefill->decode KV migration (a row or one page a hop)
  ``weights``     expert-weight regathers (live placement)
  ``collective``  the m2n combine, accounted analytically
"""
from __future__ import annotations

import abc
import os
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

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


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


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

    def gather(self, tree):
        """Host view of a result: every tensor of the nest, detached, on
        the CPU (a replicated result is whole on every rank)."""
        return _tree_map(lambda t: t.detach().cpu(), tree)

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
        return self._hop(time.perf_counter(), tree, dst, src, kind, sync, fanout)

    def _hop(self, t0, tree, dst, src, kind, sync, fanout) -> TransportHandle:
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


# ------------------------------------------------------- multi-controller
def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return None


@dataclass
class DistributedSpec:
    """Multi-process bring-up parameters (MPI-launch ergonomics): pass
    explicitly, or resolve from env — our own variables first, then the
    OpenMPI / SLURM rank variables the usual launchers export.
    ``coordinator`` is ``host:port`` of rank 0's store, or a
    ``file://`` path all ranks can reach."""
    coordinator: str = "127.0.0.1:12357"
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls) -> "DistributedSpec":
        coord = os.environ.get("REPRO_COORDINATOR", "127.0.0.1:12357")
        nproc = _env_int("REPRO_NUM_PROCESSES", "OMPI_COMM_WORLD_SIZE",
                         "SLURM_NTASKS") or 1
        pid = _env_int("REPRO_PROCESS_ID", "OMPI_COMM_WORLD_RANK",
                       "SLURM_PROCID") or 0
        return cls(coordinator=coord, num_processes=nproc, process_id=pid)


class MultiControllerTransport(InProcessTransport):
    """Multi-process backend: ``torch.distributed`` over every process.

    Bring-up (``init_process_group``) happens only with more than one
    process and when no group is up yet.  The backend is gloo where the
    ranks run on the CPU or share a card (NCCL refuses two ranks on one
    device), NCCL where each rank has a card of its own; a backend that
    fails to come up raises.  ``device``: the device this rank computes
    on; "cuda" without an index binds card ``rank % device_count``.
    None leaves tensors where they are (one process, serving).

    ``send`` follows the multihost convention of the JAX package: each
    process passes its host-local view (identical full tensors for a
    replicated layout, its own slice for a sharded one) and keeps it, so
    a hop runs no collective: it moves the tensors onto this rank's
    device, then hands them over as the in-process hop does.  The ledger
    counts payload bytes times the fan-out.  Cross-process traffic runs
    in the collectives of the code that uses the group (the m2n
    combine's ``all_reduce``)."""

    name = "multi"

    def __init__(self, spec: Optional[DistributedSpec] = None, *,
                 backend: Optional[str] = None, initialize: bool = True,
                 device=None):
        super().__init__()
        self.spec = spec if spec is not None else DistributedSpec.from_env()
        n, rank = self.spec.num_processes, self.spec.process_id
        self.device = None
        if device is not None:
            self.device = torch.device(device)
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda", rank % torch.cuda.device_count())
        if backend is None:
            own_card = (self.device is not None and self.device.type == "cuda"
                        and torch.cuda.device_count() >= n)
            backend = "nccl" if own_card else "gloo"
        self.backend = backend
        if initialize and n > 1 and not dist.is_initialized():
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            coord = self.spec.coordinator
            dist.init_process_group(
                backend, init_method=coord if "://" in coord else f"tcp://{coord}",
                world_size=n, rank=rank)

    @property
    def process_index(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def process_count(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    def send(self, tree, dst=None, *, src=None, kind: str = "tokens",
             sync: bool = False, fanout: int = 1) -> TransportHandle:
        t0 = time.perf_counter()
        if self.device is not None:
            tree = _tree_map(lambda t: t.to(self.device), tree)
            if sync and dst is None and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return self._hop(t0, tree, dst, src, kind, sync, fanout)


TRANSPORTS = {"inproc": InProcessTransport, "simrdma": SimRdmaTransport,
              "multi": MultiControllerTransport}


def make_transport(name: str, **kwargs) -> Transport:
    """Instantiate a backend by name ('inproc' | 'simrdma' | 'multi')."""
    try:
        cls = TRANSPORTS[name]
    except KeyError:
        raise ValueError(f"unknown transport {name!r}; "
                         f"choose from {sorted(TRANSPORTS)}") from None
    return cls(**kwargs)


_DEFAULT: Optional[Transport] = None


def default_transport() -> Transport:
    """The process-wide ``InProcessTransport`` that call sites with no
    transport threaded in (``serving.kvcache.migrate_kv`` /
    ``migrate_pages``) account their hops on, as the JAX package's."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = InProcessTransport()
    return _DEFAULT
