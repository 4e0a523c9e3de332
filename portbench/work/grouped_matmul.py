"""Needed work of each ``grouped_matmul`` launch: what the tokens routed
to it need, whatever the launch computed.

At the call into the router kernel (``ops.gating_dispatch``) the traced
run keeps the call's routing counts, (E,) routed (token, expert) pairs
of the live rows; each of the expert MLP's three launches that follow
(``ops.grouped_matmul``: x (E, C, K) @ w (E, K, N)) is charged for

  FLOPs  2 K N per routed pair
  bytes  the weights of the experts that hold a routed pair (K N each),
         the routed rows in (K each) and out (N each)

Rows padded to the capacity C, and experts no live row is routed to,
count for nothing: a launch that streams every expert at full capacity
reads as the share of its time the routed work needed.
"""
from __future__ import annotations

from typing import List, Tuple

KERNEL_NAMES = ("grouped_matmul_kernel",)


def install(rec):
    import repro_torch.kernels.ops as ops

    def route(orig):
        def gating_dispatch(*args, **kwargs):
            out = orig(*args, **kwargs)
            if rec.on:
                rec.log.append(("route", out[2]))
            return out
        return gating_dispatch

    def matmul(orig):
        def grouped_matmul(x, w, **kwargs):
            if rec.on:
                rec.log.append(("grouped_matmul", tuple(x.shape), int(w.shape[2]),
                                x.element_size()))
            return orig(x, w, **kwargs)
        return grouped_matmul

    rec.patch(ops, "gating_dispatch", route)
    rec.patch(ops, "grouped_matmul", matmul)


def launch_need(counts, K: int, N: int, itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) one launch needs, from its (E,) routing counts."""
    routed = float(sum(counts))
    hit = sum(1 for c in counts if c > 0)
    return 2.0 * routed * K * N, itemsize * (hit * K * N + routed * (K + N))


def need(log, run) -> List[Tuple[float, float]]:
    out, counts = [], None
    for rec in log:
        if rec[0] == "route":
            counts = rec[1].double().cpu().tolist()
        elif rec[0] == "grouped_matmul":
            (G, _, K), N, itemsize = rec[1], rec[2], rec[3]
            if counts is None or len(counts) != G:
                raise ValueError(f"a grouped_matmul launch over {G} experts "
                                 f"follows no routing of as many")
            out.append(launch_need(counts, K, N, itemsize))
    return out
