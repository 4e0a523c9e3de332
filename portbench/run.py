"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``).

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json once on this machine's card and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit.
The same numbers end standard error.

Exits non-zero and prints no result when there is no card (or fewer than
the cell asks for), when the port is not beside this directory, and when
JAX, flax or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(2, f"the port is not at {ROOT / 'src' / 'repro_torch'}")
    # the caches of the run stay inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "portbench_cache" / sub))
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    from harness import spec as spec_lib
    cell = spec_lib.Cell(spec_lib.load_benchmark(ROOT), args.workload, ROOT)

    import torch
    if not torch.cuda.is_available():
        fail(3, "no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(3, f"{cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
    from harness.bench import measure
    out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  t_proc=T_PROC)
    bad = forbidden_modules()
    if bad:
        fail(4, f"the run loaded {bad}: the port must not load JAX or the "
                f"JAX package")
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    device.update(out["device_extra"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in out["metrics"].items()},
              "device": device, "card": card_info(),
              "setup_phases": out["setup_phases"], "window": out["window"],
              "sampled": out["sampled"]}
    if args.trace and out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["check"] = out["check"]
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
