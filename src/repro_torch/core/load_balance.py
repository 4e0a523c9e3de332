"""Expert load balancing with on-device redundancy (paper §6), copied
from the JAX package's ``core/load_balance.py`` (numpy only) so the port
imports nothing of it.

Distribute M experts across N expert nodes minimizing
    max_{j=1..N} C_j,   C_j = sum_i x_ij * max(a_i, K),
where x_ij are allocation fractions (sum_j x_ij = 1), a_i is expert i's
measured traffic cost and K the floor cost of a cold expert.  Hot experts
may be *replicated* (fractionally split across nodes); cold experts are
packed whole.  Greedy approximation: water-filling against the ideal
per-node level, processing experts in descending cost (LPT).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


@dataclass
class Placement:
    # fractions[i][j] = share of expert i served by node j
    fractions: np.ndarray
    node_cost: np.ndarray
    max_cost: float
    ideal: float

    @property
    def imbalance(self) -> float:
        return self.max_cost / self.ideal if self.ideal > 0 else 1.0


def balance_experts(loads, n_nodes: int, cold_floor: float = 1.0,
                    allow_replication: bool = True) -> Placement:
    """Greedy fractional placement of len(loads) experts onto n_nodes."""
    costs = np.maximum(np.asarray(loads, dtype=np.float64), cold_floor)
    M = len(costs)
    total = costs.sum()
    frac = np.zeros((M, n_nodes))
    node_cost = np.zeros(n_nodes)
    # heap of (cost, node)
    heap = [(0.0, j) for j in range(n_nodes)]
    heapq.heapify(heap)
    level = total / n_nodes
    order = np.argsort(-costs)
    for i in order:
        c = float(costs[i])
        if allow_replication and c > level:
            # hot expert: split across the emptiest nodes up to the level
            remaining = c
            while remaining > 1e-12:
                base, j = heapq.heappop(heap)
                room = max(level - base, remaining / n_nodes)
                take = min(remaining, room)
                frac[i, j] += take / c
                node_cost[j] = base + take
                heapq.heappush(heap, (node_cost[j], j))
                remaining -= take
        else:
            base, j = heapq.heappop(heap)
            frac[i, j] = 1.0
            node_cost[j] = base + c
            heapq.heappush(heap, (node_cost[j], j))
    return Placement(frac, node_cost, float(node_cost.max()), float(level))


def replication_plan(placement: Placement, threshold: float = 1e-9):
    """Which experts live on which nodes (the deployment artifact)."""
    M, N = placement.fractions.shape
    return {j: [i for i in range(M) if placement.fractions[i, j] > threshold]
            for j in range(N)}


def static_placement(n_experts: int, n_nodes: int,
                     loads=None, cold_floor: float = 1.0) -> Placement:
    """The contiguous-block placement the unbalanced serving path uses:
    expert i lives (whole) on node i // ceil(M/N).  ``loads`` (optional)
    prices the node costs; default is uniform traffic."""
    e_loc = -(-n_experts // n_nodes)
    frac = np.zeros((n_experts, n_nodes))
    frac[np.arange(n_experts), np.arange(n_experts) // e_loc] = 1.0
    if loads is None:
        loads = np.ones(n_experts)
    return evaluate_placement(frac, loads, cold_floor)


def evaluate_placement(fractions: np.ndarray, loads,
                       cold_floor: float = 1.0) -> Placement:
    """Price an existing placement against a (possibly newer) traffic
    trace: node j's cost is its fractional share of each expert's
    floored load.  Used by ``Engine.stats()`` to report the live
    imbalance of whatever placement the runtime currently serves."""
    fractions = np.asarray(fractions, dtype=np.float64)
    costs = np.maximum(np.asarray(loads, dtype=np.float64), cold_floor)
    node_cost = fractions.T @ costs
    ideal = costs.sum() / fractions.shape[1]
    return Placement(fractions, node_cost, float(node_cost.max()),
                     float(ideal))


@dataclass
class PlacementTables:
    """Dense lookup tables a serving runtime needs to *execute* a
    ``Placement`` with replicated experts.

    The runtime views each of the N expert nodes as holding S "virtual
    expert slots"; expert weights are gathered into an (N*S, ...) array
    (node-major) and token routing targets virtual slot ids.

      slot_experts[j, s]  global expert id in node j's slot s (-1 = pad)
      rep_node[i, r]      node hosting expert i's r-th replica
      rep_slot[i, r]      that replica's slot index within its node
      rep_cum[i, r]       cumulative traffic fraction; a token with hash
                          u in [0, 1) goes to the first replica with
                          u < rep_cum[i, r] (last entry is 1.0, unused
                          replica entries repeat the last real one)
    """
    slot_experts: np.ndarray   # (N, S) int32
    rep_node: np.ndarray       # (M, R) int32
    rep_slot: np.ndarray       # (M, R) int32
    rep_cum: np.ndarray        # (M, R) float32
    fractions: np.ndarray      # (M, N) effective (post-repair) fractions

    @property
    def n_nodes(self) -> int:
        return self.slot_experts.shape[0]

    @property
    def slots_per_node(self) -> int:
        return self.slot_experts.shape[1]

    @property
    def max_replicas(self) -> int:
        return self.rep_node.shape[1]


def placement_tables(placement: Placement, slots_per_node: int,
                     threshold: float = 1e-6) -> PlacementTables:
    """Compile a fractional ``Placement`` into executable lookup tables
    under a fixed per-node slot budget.

    The greedy solver can emit more replicas than a node has slots for
    (or, without replication, pack many cold experts onto one node), so
    the compile step *repairs*: replicas are admitted largest-fraction
    first, every expert's largest replica is guaranteed a slot (spilled
    to the emptiest node if its own is full — requires N*S >= M), and
    each expert's admitted fractions are renormalized to sum to 1, so
    the tables always route every token somewhere valid.
    """
    frac = np.asarray(placement.fractions, dtype=np.float64)
    M, N = frac.shape
    S = slots_per_node
    if N * S < M:
        raise ValueError(f"{N} nodes x {S} slots cannot host {M} experts")
    n_slots = np.zeros(N, dtype=np.int64)
    kept = np.zeros((M, N))
    # pass 1: every expert's largest replica gets a slot, spilling to the
    # emptiest node when the preferred one is full
    for i in np.argsort(-frac.max(axis=1)):
        j = int(np.argmax(frac[i]))
        if n_slots[j] >= S:
            j = int(np.argmin(n_slots))
        kept[i, j] = max(frac[i].max(), threshold)
        n_slots[j] += 1
    # pass 2: remaining replicas, largest fraction first, while room
    order = np.dstack(np.unravel_index(np.argsort(-frac, axis=None),
                                       frac.shape))[0]
    for i, j in order:
        if frac[i, j] <= threshold or kept[i, j] > 0:
            continue
        if n_slots[j] < S:
            kept[i, j] = frac[i, j]
            n_slots[j] += 1
    kept /= kept.sum(axis=1, keepdims=True)

    slot_experts = np.full((N, S), -1, dtype=np.int32)
    slot_of = np.full((M, N), -1, dtype=np.int32)
    fill = np.zeros(N, dtype=np.int64)
    for i in range(M):
        for j in np.nonzero(kept[i] > 0)[0]:
            slot_experts[j, fill[j]] = i
            slot_of[i, j] = fill[j]
            fill[j] += 1
    # the replica dimension is padded to the fixed bound R = N (an
    # expert holds at most one slot per node), so the table shapes are
    # placement-independent and a runtime can re-apply new placements
    # without retracing its jitted dispatch
    R = N
    rep_node = np.zeros((M, R), dtype=np.int32)
    rep_slot = np.zeros((M, R), dtype=np.int32)
    rep_cum = np.ones((M, R), dtype=np.float32)
    for i in range(M):
        nodes = np.nonzero(kept[i] > 0)[0]
        cum = np.cumsum(kept[i, nodes])
        cum[-1] = 1.0  # guard rounding: the last replica takes the rest
        for r in range(R):
            rr = min(r, len(nodes) - 1)
            rep_node[i, r] = nodes[rr]
            rep_slot[i, r] = slot_of[i, nodes[rr]]
            rep_cum[i, r] = cum[rr]
    return PlacementTables(slot_experts, rep_node, rep_slot, rep_cum, kept)
