#!/usr/bin/env python3
"""Time the port's two router kernels, ``gating_topk`` and
``gating_dispatch``, from several source trees in one run on one NVIDIA
GPU, so that versions are compared on the same card in the same call.

    python3 scripts/time_route_kernels.py --make-one-group build/one_group
    python3 scripts/time_route_kernels.py --tree build/parent --tree . \\
        --tree build/one_group --tree build/one_group --tree . --tree build/parent

A tree is the root of a checkout of this repository (``git archive`` of
a commit unpacked under ``build/``, or this checkout, ``.``).  Trees run
in the order given, each in a process of its own that imports the
tree's ``src/repro_torch`` and builds its kernels into the tree's
``build/repro_torch_kernels``.  ``--make-one-group DIR`` writes a copy
of this checkout's ``src`` to ``DIR`` in which the router kernels'
cluster front end (``csrc/route.cuh``) gives each thread one logit over
all the rows of its block (G = 1), instead of splitting the rows among
G thread groups when there are fewer logits than threads.

Each tree's run checks each kernel against its plain version and times
it with ``chip_smoke.time_ms`` (median of 50 calls, a spin kernel
before each), once with an L2 flush before every call (as
``chip_smoke.py`` times it) and once without (inputs warm in L2), at
mixtral-8x22b's router for one decode micro-batch: x (T, 6144) bf16,
router (6144, 8) f32, top-2, ``gating_topk`` and ``gating_dispatch``
(capacity C = T) at T = 4 and 8, and both at T = 4 at qwen2-moe-a2.7b's
router (d 2048, 60 experts, top-4) and arctic-480b's (d 7168, 128
experts, top-2); then
``gating_dispatch``'s two branches at T = 4: the placement tables of
4 nodes x 4 slots (the rebalanced path's call) and the owner filter of
shard 0 of 4 (the m2n path's), null for a tree without them.  It prints
the card's name and power limit, then one JSON line per tree.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROW_GROUPS = "  const int G = nout >= NT ? 1 : NT / nout;\n"


def make_one_group(dst: Path):
    """Copy this checkout's src to dst/src with G = 1 in the cluster front end."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src" / "repro_torch" / "csrc" / "route.cuh"
    text = cu.read_text()
    if text.count(ROW_GROUPS) != 1:
        raise SystemExit(f"{cu}: the row-group line was not found once")
    cu.write_text(text.replace(ROW_GROUPS, "  const int G = 1;\n"))


def worker(tree: Path) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.gating_dispatch import gating_dispatch_plain
    from repro_torch.kernels.gating_topk import gating_topk_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    d, E, K = 6144, 8, 2
    wr = (torch.randn(d, E, device=dev, generator=gen) * d ** -0.5).float()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()  # a second of device work: working clocks
    while time.perf_counter() - t0 < 1.0:
        flush.zero_()
        torch.cuda.synchronize()

    def times(fn):
        return {"flush_ms": chip_smoke.time_ms(torch, fn, reps=50, flush=flush),
                "warm_ms": chip_smoke.time_ms(torch, fn, reps=50)}

    out = {"tree": str(tree)}
    routers = (("", d, E, K), (" qwen2-moe-a2.7b", 2048, 60, 4),
               (" arctic-480b", 7168, 128, 2))
    for model, dm, Em, Km in routers:
        wm = wr if not model else (torch.randn(dm, Em, device=dev, generator=gen)
                                   * dm ** -0.5).float()
        for T in ((4, 8) if not model else (4,)):
            x = torch.randn(T, dm, device=dev, generator=gen).bfloat16()
            got, want = kops.gating_topk(x, wm, Km), gating_topk_plain(x, wm, Km)
            chip_smoke.check_topk(torch, f"gating_topk{model} T={T}", got, want)
            out[f"gating_topk{model} T={T}"] = times(lambda: kops.gating_topk(x, wm, Km))
            cw = torch.ones(T, device=dev)
            got = kops.gating_dispatch(x, wm, Km, Em, T, count_weights=cw)
            want = gating_dispatch_plain(x, wm, Km, Em, T, count_weights=cw)
            chip_smoke.require(torch.equal(got[0], want[0])
                               and torch.equal(got[2], want[2]),
                               f"gating_dispatch{model} T={T}: idx_buf or counts differ")
            chip_smoke.check_close(torch, f"gating_dispatch{model} T={T}", got[1],
                                   want[1], 1e-5, 1e-5)
            out[f"gating_dispatch{model} T={T}"] = times(
                lambda: kops.gating_dispatch(x, wm, Km, Em, T, count_weights=cw))
    # the kernel's placement-table and owner-filter branches at T = 4, after
    # the rows above so they leave them as they were; null where the
    # tree's kernel or package has no such branch
    x, cw = torch.randn(4, d, device=dev, generator=gen).bfloat16(), cw[:4]
    cases = {"gating_dispatch tables T=4": 16, "gating_dispatch owner T=4": 8}
    try:
        _, S, tk = chip_smoke.placement_case(torch, dev, [100.0] + [4.0] * 7, 4)
        kws = {"gating_dispatch tables T=4": tk,
               "gating_dispatch owner T=4": dict(owner=0, slots_per_node=2)}
        for label, nb in cases.items():
            kw = dict(kws[label], count_weights=cw)
            got = kops.gating_dispatch(x, wr, K, nb, 4, **kw)
            want = gating_dispatch_plain(x, wr, K, nb, 4, **kw)
            chip_smoke.require(torch.equal(got[0], want[0])
                               and torch.equal(got[2], want[2]),
                               f"{label}: idx_buf or counts differ")
            out[label] = times(lambda: kops.gating_dispatch(x, wr, K, nb, 4, **kw))
    except (ImportError, NotImplementedError):
        out.update(dict.fromkeys(cases))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, default=[])
    ap.add_argument("--make-one-group", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    if args.make_one_group is not None:
        make_one_group(args.make_one_group.resolve())
        return 0
    import chip_smoke
    print(chip_smoke.card_line())
    for tree in args.tree or [ROOT]:
        r = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
