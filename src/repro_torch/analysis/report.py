"""Aggregate the dry run's JSON records (``launch.dryrun``) into its tables:
the JAX package's ``analysis/report.py``, reading only the records, so it
renders either package's.

  PYTHONPATH=src python -m repro_torch.analysis.report DIR
"""
from __future__ import annotations

import glob
import json
import os
import sys

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        r["_file"] = os.path.basename(p)
        recs.append(r)
    return recs


def fmt_bytes(n):
    if n is None:
        return "-"
    return f"{n / 1e9:.2f}"


def roofline_table(recs, mesh="16x16", moe_impl="baseline"):
    rows = []
    recs = [r for r in recs if r.get("status") == "ok"
            and r.get("mesh") == mesh
            and r.get("moe_impl", "baseline") == moe_impl
            and r.get("expert_mode", "ep") == "ep"
            and not r.get("fsdp")
            and "_seqpar" not in r.get("_file", "")
            and "_chunk" not in r.get("_file", "")]
    rows.append("| arch | shape | T_comp (ms) | T_mem (ms) | T_coll (ms) | "
                "bottleneck | useful FLOPs | MFU bound | HBM GB/dev | "
                "compile (s) |")
    rows.append("|---|---|---|---|---|---|---|---|---|---|")
    key = lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"]))
    for r in sorted(recs, key=key):
        rf = r["roofline"]
        mem = r["memory_analysis"]
        tot = sum(v for k, v in mem.items()
                  if k in ("argument_size", "output_size", "temp_size")
                  and v) if isinstance(mem, dict) else None
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['t_compute']*1e3:.2f} | "
            f"{rf['t_memory']*1e3:.2f} | {rf['t_collective']*1e3:.3f} | "
            f"{rf['bottleneck']} | {rf['useful_flops_ratio']:.2f} | "
            f"{rf['mfu_bound']:.3f} | {fmt_bytes(tot)} | "
            f"{r['t_compile_s']:.0f} |")
    return "\n".join(rows)


def dryrun_table(recs):
    rows = ["| arch | shape | mesh | status | flops/dev | coll bytes/dev | "
            "note |", "|---|---|---|---|---|---|---|"]
    key = lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"]), r.get("mesh", ""))
    for r in sorted(recs, key=key):
        if r["status"] == "ok":
            rf = r["roofline"]
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                        f"{rf['hlo_flops']:.2e} | {rf['coll_bytes']:.2e} | "
                        f"{dict_short(rf['coll_breakdown'])} |")
        else:
            rows.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh','-')} "
                        f"| {r['status']} | - | - | {r.get('note', r.get('error',''))[:80]} |")
    return "\n".join(rows)


def dict_short(d):
    return " ".join(f"{k.replace('all-','a')}={v/1e6:.1f}MB"
                    for k, v in sorted(d.items())) or "none"


def variant_label(r):
    bits = []
    if r.get("moe_impl", "baseline") != "baseline":
        bits.append(r["moe_impl"])
    if r.get("expert_mode", "ep") != "ep":
        bits.append(r["expert_mode"])
    if r.get("fsdp"):
        bits.append("fsdp")
    f = r.get("_file", "")
    if "_seqpar" in f:
        bits.append("seqpar")
    if "_chunk" in f:
        bits.append("chunk" + f.split("_chunk")[1].split(".")[0].split("_")[0])
    return "+".join(bits) or "baseline"


def perf_table(recs, pairs):
    rows = ["| pair | variant | T_comp (ms) | T_mem (ms) | T_coll (ms) | "
            "bottleneck | useful | args GB/dev | temp GB/dev |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch, shape in pairs:
        sel = [r for r in recs if r.get("status") == "ok"
               and r["arch"] == arch and r["shape"] == shape
               and r.get("mesh") == "16x16"]
        for r in sel:
            rf = r["roofline"]
            m = r["memory_analysis"]
            rows.append(
                f"| {arch} × {shape} | {variant_label(r)}"
                f"{' remat=' + r['remat'] if r.get('remat') not in (None, 'full') else ''} | "
                f"{rf['t_compute']*1e3:.2f} | {rf['t_memory']*1e3:.2f} | "
                f"{rf['t_collective']*1e3:.2f} | {rf['bottleneck']} | "
                f"{rf['useful_flops_ratio']:.3f} | "
                f"{(m.get('argument_size') or 0)/1e9:.1f} | "
                f"{(m.get('temp_size') or 0)/1e9:.1f} |")
    return "\n".join(rows)


PERF_PAIRS = [("arctic-480b", "decode_32k"),
              ("qwen2-moe-a2.7b", "prefill_32k"),
              ("mamba2-1.3b", "prefill_32k"),
              ("minitron-4b", "prefill_32k")]


def merge_rolled_trains(recs, rolled_dir):
    """Fill train_4k gaps with rolled-scan runs (annotated): XLA counts a
    while body once, so rolled cost_analysis undercounts by ~n_blocks —
    we apply the x n_blocks correction to flops/bytes/collectives and tag
    the row."""
    from repro_torch.config import get_config
    have = {(r["arch"], r["shape"], r.get("mesh"))
            for r in recs if r.get("status") == "ok"}
    if not os.path.isdir(rolled_dir):
        return recs
    for r in load(rolled_dir):
        key = (r["arch"], r["shape"], r.get("mesh"))
        if r.get("status") != "ok" or key in have:
            continue
        nb = get_config(r["arch"]).n_blocks
        rf = r["roofline"]
        for k in ("hlo_flops", "hlo_bytes", "coll_bytes", "t_compute",
                  "t_memory", "t_collective"):
            if k in rf and rf[k] is not None:
                rf[k] = rf[k] * nb
        rf["useful_flops_ratio"] = (rf["model_flops"] / rf["hlo_flops"]
                                    if rf["hlo_flops"] else 0.0)
        terms = {"compute": rf["t_compute"], "memory": rf["t_memory"],
                 "collective": rf["t_collective"]}
        rf["bottleneck"] = max(terms, key=terms.get)
        rf["mfu_bound"] = ((rf["model_flops"] / rf["peak_flops"])
                           / max(terms.values()) if max(terms.values()) else 0)
        r["arch"] = r["arch"] + " (rolled×L)"
        recs.append(r)
    return recs


def main():
    dir_ = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun"
    recs = load(dir_)
    recs = merge_rolled_trains(recs, os.path.join(dir_, "trains_rolled"))
    print("## §Roofline (single-pod 16x16, baseline, unrolled)\n")
    print(roofline_table(recs))
    print("\n## §Dry-run (all meshes)\n")
    print(dryrun_table(recs))
    print("\n## §Perf variants\n")
    print(perf_table(recs, PERF_PAIRS))


if __name__ == "__main__":
    main()
