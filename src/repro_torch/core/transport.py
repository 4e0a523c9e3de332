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
    card of its own.  In one process it is the in-process hop.  Across
    ranks of the disaggregated layout (``setup_serving``) a hop is a
    ``broadcast`` from its source rank in a group made for it at
    bring-up, or a zero-filled ``all_reduce`` (gloo takes no other
    collective on a CUDA tensor); the source accounts the hop, and every
    rank records its wait on the hops it takes part in.

Hop kinds:

  ``tokens``      M2N dispatch / N2M return of token activations
  ``kv``          prefill->decode KV migration (a row or one page a hop)
  ``weights``     expert-weight regathers (live placement)
  ``collective``  the m2n combine, accounted analytically
"""
from __future__ import annotations

import abc
import os
import pickle
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

HOP_KINDS = ("tokens", "kv", "weights", "collective")


def _leaves(tree):
    """The tensors of a nest, dict entries by sorted key (the order
    ``_tree_map`` and a hop's byte layout follow on every rank)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
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
        return self.record("collective", nbytes, fanout=fanout)

    def record(self, kind: str, nbytes: int, *, fanout: int = 1,
               issue_s: float = 0.0) -> TransportHandle:
        """Account one hop of ``kind`` carrying ``nbytes`` on the wire (a
        hop whose data moved elsewhere: a collective, or a hop between
        ranks); priced by the backend's cost model."""
        h = TransportHandle(kind=kind, nbytes=int(nbytes), issue_s=issue_s,
                            fanout=fanout)
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
        self._waits = {}
        self.roles = None
        self.groups = {}
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

    # ------------------------------------------------ hops between ranks
    def setup_serving(self, roles) -> None:
        """Make every process group the disaggregated layout's hops need,
        once, in the same order on every rank (a group made per hop would
        cost its bring-up each time, and deadlock where a rank skipped
        it): ``decode`` (attention and expert ranks), ``expert``, ``kv``
        (prefill and attention ranks), ``("mb", a)`` for each attention
        rank a (a and the expert ranks: its micro-batches' M2N and N2M
        hops), and one group for every pair of ranks.  ``roles``: a
        ``launch.mesh.ServingRoles`` of this world."""
        self.roles = roles
        self.groups = {}
        if self.process_count != roles.world:
            raise ValueError(f"{roles} for a world of {self.process_count}")

        def new(ranks):
            ranks = sorted(set(ranks))
            # every rank makes every group, in this order, members or not
            return dist.new_group(ranks) if len(ranks) > 1 else None

        self.groups["decode"] = new(roles.decode)
        self.groups["expert"] = new(roles.expert)
        self.groups["kv"] = new(set(roles.prefill) | set(roles.attn))
        for a in roles.attn:
            self.groups["mb", a] = new({a} | set(roles.expert))
        for i in range(roles.world):
            for j in range(i + 1, roles.world):
                self.groups[i, j] = new((i, j))

    def pair(self, a: int, b: int):
        """The group of ranks a and b."""
        return self.groups[min(a, b), max(a, b)]

    def _wait(self, kind: str, seconds: float):
        w = self._waits.setdefault(kind, [0.0, 0])
        w[0] += seconds
        w[1] += 1

    def broadcast(self, tree, *, root: int, group, kind: str, like=None,
                  async_op: bool = False, account: bool = True) -> "RankHop":
        """One hop from rank ``root`` to the other ranks of ``group``: a
        ``broadcast`` of ``tree`` (on the root; its leaves packed into one
        byte buffer) into buffers shaped as ``like`` (elsewhere).  The
        root accounts ``kind`` with the payload's bytes (unless
        ``account`` is False: a hop its caller accounts as a whole);
        ``RankHop.wait`` returns the tree and records the wait (at once
        where ``async_op`` is False)."""
        t0 = time.perf_counter()
        me = self.process_index
        src = tree if me == root else like
        leaves = list(_leaves(src))
        one = len(leaves) == 1 and isinstance(src, torch.Tensor)
        if one:
            # bytes on the wire whatever the dtype (gloo's collectives
            # do not all take bf16)
            out = tree.contiguous() if me == root else torch.empty_like(like)
            buf = out.view(torch.uint8)
        elif me == root:
            buf = torch.cat([t.contiguous().view(torch.uint8).reshape(-1)
                             for t in leaves])
        else:
            buf = torch.empty(sum(t.numel() * t.element_size() for t in leaves),
                              dtype=torch.uint8, device=leaves[0].device)
        work = dist.broadcast(buf, src=root, group=group, async_op=True)
        if me == root and account:
            self.record(kind, buf.numel(), issue_s=time.perf_counter() - t0)
        unpack = (lambda: out) if one else (lambda: _unpack(buf, src))
        return RankHop(self, kind, work, unpack, wait=not async_op)

    def reduce_hop(self, t: torch.Tensor, *, group, kind: str,
                   async_op: bool = False) -> "RankHop":
        """One hop as a sum: every rank of ``group`` adds ``t`` in place
        (a receiver passes zeros, so it gets the senders' sum: a dense
        FFN's partial outputs, or each rank's share of the routing
        counts).  Its wait goes to ``kind``; the caller accounts it."""
        work = dist.all_reduce(t, group=group, async_op=True)
        return RankHop(self, kind, work, lambda: t, wait=not async_op)

    def gather_objects(self, obj, group=None, ranks=None) -> list:
        """Every rank's ``obj`` (picklable), in rank order, on every rank
        of ``group`` (the world by default; ``ranks``: the group's ranks):
        each rank's bytes written into its part of zero-filled buffers,
        summed (gloo takes only ``all_reduce`` / ``broadcast`` on a CUDA
        tensor)."""
        ranks = list(ranks) if ranks is not None else list(range(self.process_count))
        if len(ranks) == 1:
            return [obj]
        dev = self._wire_device()
        mine = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        i = ranks.index(self.process_index)
        sizes = torch.zeros(len(ranks), dtype=torch.int64, device=dev)
        sizes[i] = mine.numel()
        dist.all_reduce(sizes, group=group)
        sizes = sizes.tolist()
        buf = torch.zeros(sum(sizes), dtype=torch.uint8, device=dev)
        off = sum(sizes[:i])
        buf[off:off + sizes[i]] = mine.to(dev)
        dist.all_reduce(buf, group=group)
        data, out, off = buf.cpu().numpy().tobytes(), [], 0
        for n in sizes:
            out.append(pickle.loads(data[off:off + n]))
            off += n
        return out

    def barrier(self):
        """Every rank waits for all the others (nothing in one process)."""
        if self.process_count > 1:
            dist.barrier()

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over every rank: the rows each rank made,
        zeros elsewhere (sampled tokens)."""
        dist.all_reduce(t)
        return t

    def broadcast_ints(self, values, *, root: int, n: int) -> list:
        """``n`` int64 values from rank ``root`` (its ``values``, padded
        with zeros) to every rank: a decision made on one rank."""
        buf = torch.zeros(n, dtype=torch.int64, device=self._wire_device())
        if self.process_index == root:
            buf[:len(values)] = torch.as_tensor(list(values), dtype=torch.int64)
        dist.broadcast(buf, src=root)
        return buf.tolist()

    def _wire_device(self):
        """Where a small control tensor goes: the host under gloo, this
        rank's card under NCCL (which takes no host tensor)."""
        if self.backend == "nccl" and self.device is not None:
            return self.device
        return torch.device("cpu")

    def stats(self) -> dict:
        """The ledger of the hops this rank sent; across ranks each kind
        also carries ``wait_s`` / ``waits``: this rank's time blocked on
        the hops it took part in, not put into ``sim_s``."""
        out = super().stats()
        for kind, (sec, n) in self._waits.items():
            hop = out.setdefault(kind, {"hops": 0, "bytes": 0, "issue_s": 0.0,
                                        "sim_s": 0.0})
            hop.update(wait_s=sec, waits=n)
        return out

    def reset_stats(self):
        super().reset_stats()
        self._waits = {}


def _unpack(buf: torch.Tensor, like):
    """The tree of ``like``'s structure whose leaves are consecutive byte
    spans of ``buf``, each viewed as its template leaf's dtype and shape."""
    off = [0]

    def leaf(t):
        n = t.numel() * t.element_size()
        out = buf[off[0]:off[0] + n].view(t.dtype).reshape(t.shape)
        off[0] += n
        return out

    return _tree_map(leaf, like)


class RankHop:
    """A hop between ranks in flight: ``wait()`` blocks until it is done
    (the host time goes to the transport's wait ledger) and returns the
    received tree (the sent one on its source)."""

    def __init__(self, transport, kind: str, work, result, wait: bool = False):
        self.transport, self.kind, self.work, self._result = \
            transport, kind, work, result
        if wait:            # a blocking hop: its wait is taken now
            self.wait()

    def wait(self):
        if self.work is not None:
            t0 = time.perf_counter()
            self.work.wait()
            self.transport._wait(self.kind, time.perf_counter() - t0)
            self.work = None
        return self._result()


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
