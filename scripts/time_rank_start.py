#!/usr/bin/env python3
"""Time the start of a group of gloo rank processes on one NVIDIA GPU:
from the parent's request to every rank holding a CUDA context and a
process group, each rank a fresh interpreter
(``repro_torch.launch.dist_smoke.run_ranks``) or forked from a process
that has imported torch and the port and run a meta-device draw, and
touched no card (``chip_smoke.forker_imports`` and ``fork_ranks``, how
``chip_smoke.py`` starts the ranks of phases 9-14).

    python3 scripts/time_rank_start.py [--procs 2 4 5]

Prints the card's name and power limit, then one line per group size
and way: the wall time of the group and the slowest rank's seconds to
import torch, make its CUDA context and join the process group, and
then to run its first meta-device draw (how a layout starts).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ready(argv) -> int:
    """One rank: the seconds from the request (``argv[0]``, a wall-clock
    time) to each step of its start."""
    t0 = time.time()
    import torch
    t1 = time.time()
    torch.zeros(1, device="cuda")
    t2 = time.time()
    import torch.distributed as dist
    from repro_torch.config import get_config
    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.models.transformer import init_params
    tr = MultiControllerTransport(device="cuda")
    dist.barrier()
    t3 = time.time()
    init_params(get_config("qwen2-moe-a2.7b"), device="meta")  # a layout's first step
    t4 = time.time()
    print("ready " + json.dumps(dict(rank=tr.process_index, interpreter=t0 - float(argv[0]),
                                     import_torch=t1 - t0, cuda=t2 - t1,
                                     process_group=t3 - t2, meta_draw=t4 - t3,
                                     request_to_ready=t3 - float(argv[0]))), flush=True)
    dist.destroy_process_group()
    return 0


def report(label, n, wall, out):
    rows = [json.loads(ln[len("ready "):]) for rc, text in out
            for ln in text.splitlines() if ln.startswith("ready ")]
    if len(rows) != n or any(rc for rc, _ in out):
        raise SystemExit(f"{label}: {n} ranks did not all start:\n"
                         + "\n".join(text[-2000:] for _, text in out))
    worst = max(rows, key=lambda r: r["request_to_ready"])
    print(f"{n} ranks, {label}: group {wall:.2f} s; slowest rank: interpreter "
          f"{worst['interpreter']:.2f} s, import torch {worst['import_torch']:.2f} s, "
          f"CUDA context {worst['cuda']:.2f} s, process group "
          f"{worst['process_group']:.2f} s, ready after {worst['request_to_ready']:.2f} s; "
          f"then a meta-device draw of qwen2-moe-a2.7b {worst['meta_draw']:.2f} s",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, nargs="+", default=[2, 4, 5])
    ap.add_argument("--ready", nargs=1, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ready:              # a rank started as a fresh interpreter
        rc = ready(args.ready)
        sys.stdout.flush()
        os._exit(rc)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["OMP_NUM_THREADS"] = "1"
    import chip_smoke
    from repro_torch.launch.dist_smoke import run_ranks
    print(chip_smoke.card_line())
    chip_smoke.RANK_CHILDREN["--ready"] = ready
    for n in args.procs:
        t = time.time()
        out = run_ranks([__file__, "--ready", repr(t)], n, timeout=120)
        report("fresh interpreters", n, time.time() - t, out)
        chip_smoke.forker_imports()     # once: the forked ranks inherit it
        t = time.time()
        out = chip_smoke.fork_ranks(["--ready", repr(t)], n, 120)
        report("forked", n, time.time() - t, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
