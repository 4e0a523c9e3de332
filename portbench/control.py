"""The readings that the check's limits are set from, for one cell: the
program's widest logit gap over many seeds, and the control's.

  python3 portbench/control.py --workload <cell> --seeds 11 12 13 ... \
      --seconds <s> [--out control.jsonl]

For each seed one whole run of the cell (set-up, window, check) is made
in this one process, and once the program's state is freed the reference
is run a second time over the same prompts and served tokens with its
matrix products in float8 e4m3 (``linear="fp8"``): the control.  At each
served position the control's first token is read against the float32
reference, as a served token is.  A control whose widest gap stays
under the cell's limit would show the limit too loose to tell the
configuration's precision from the one below it.

Prints one JSON line per seed: the program's and the control's readings
(``harness.check.summary``), each one's verdict under the cell's limits
(``harness.check.verdict``, the comparison that decides a run's
``correct``), and the served tokens compared.

``--fault <name>`` plants one of ``faults.py``'s faults in the timed path
and runs the program alone (no control): its readings and verdict are
the fault's at the cell's own size.

``--dtype`` and ``--layers`` run the cell's configuration in another
precision or depth instead (a witness: the program in float32 at a depth
that fits reads float32 rounding, so what it reads in bf16 is bf16's).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def control_hook(store: dict):
    """``measure``'s ``after_window``: the control's gaps on the sample."""
    from harness import check as check_lib

    def hook(loop, ctx):
        torch, ref = ctx["torch"], ctx["ref"]
        seqs = check_lib.sequences(ctx["picked"])
        low = ref.logits(ctx["weights"], ctx["config"], seqs, ctx["device"],
                         linear="fp8")
        store["control"] = check_lib.control_gaps_of(torch, ctx["ref_logits"], low,
                                                     ctx["picked"])
    return hook


def one_seed(cell, seed: int, seconds: float, device: str,
             control: bool = True) -> dict:
    from harness.bench import measure
    from harness.check import summary, verdict
    store: dict = {}
    limits = cell.check.get("limits", {})
    t = time.perf_counter()
    out = measure(cell, seed, seconds, False, device,
                  after_window=control_hook(store) if control else None)
    row = {"seed": seed, "correct": out["correct"],
           "program": summary(out["gaps"]),
           "program_verdict": verdict(summary(out["gaps"]), limits),
           "tokens": int(out["gaps"].size), "requests": len(out["sampled"]),
           "longest": max((g for _, _, g in out["sampled"]), default=0),
           "metrics": out["metrics"], "seconds": time.perf_counter() - t}
    if control:
        row["control"] = summary(store["control"])
        row["control_verdict"] = verdict(row["control"], limits)
    row["limits"] = limits
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--dtype", default="", help="run the config in this dtype")
    ap.add_argument("--layers", type=int, default=0, help="... at this depth")
    ap.add_argument("--fault", default="", help="plant this fault (faults.py)")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from harness import spec as spec_lib
    if not torch.cuda.is_available():
        sys.exit("control: no CUDA device")
    cell = spec_lib.Cell(spec_lib.load_benchmark(ROOT), args.workload, ROOT)
    if args.dtype:
        cell.config = dict(cell.config, torch_dtype=args.dtype)
    if args.layers:
        cell.config = dict(cell.config, num_hidden_layers=args.layers)
    if args.fault:
        import faults
        faults.plant(args.fault)
    for seed in args.seeds:
        row = one_seed(cell, seed, args.seconds, "cuda", control=not args.fault)
        row.update(workload=args.workload, dtype=cell.config["torch_dtype"],
                   layers=cell.config["num_hidden_layers"], fault=args.fault or None)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
