"""Serving launcher of the port: the continuous-batching engine over the
monolithic decode path or the ping-pong disaggregated runtime, on the
card unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.serve --reduced --runtime pingpong \\
      --microbatches 2 --requests 8 --max-new 8
  python -m repro_torch.launch.serve --arch mixtral-8x22b --n-layers 4 \\
      --dtype bfloat16 --runtime pingpong --microbatches 2 --max-batch 8
  python -m repro_torch.launch.serve --reduced --device cpu \\
      --runtime pingpong --microbatches 2 --kv-layout paged --page-size 8 \\
      --prompt-len 32 --shared-prefix-len 24
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.config import get_config, reduced
from repro_torch.core.disagg import STAGES, DisaggPlan, DisaggregatedInstance
from repro_torch.models.transformer import init_params
from repro_torch.serving.config import (DTYPES, KV_LAYOUTS, RUNTIMES,
                                        ServingConfig)
from repro_torch.serving.engine import Engine, Request


def format_stages(report: dict) -> str:
    per_stage = " ".join(f"{s}={report[f'{s}_s'] * 1e3:.3f}ms/{report[f'{s}_n']}"
                         for s in STAGES)
    return (f"stages: {per_stage} | per-op t_a={report['t_a'] * 1e6:.1f}us "
            f"t_e={report['t_e'] * 1e6:.1f}us")


def format_phases(ph: dict) -> str:
    return (f"phases: prefill={ph['prefill_s'] * 1e3:.1f}ms/{ph['prefills']} "
            f"transfer={ph['transfer_s'] * 1e3:.1f}ms/{ph['transfer_n']} "
            f"decode={ph['decode_s'] * 1e3:.1f}ms/{ph['decode_n']}")


def format_pages(stats: dict) -> str:
    kp = stats["kv_pages"]
    line = (f"kv[paged]: {kp['used']}/{kp['n_pages']} pages of "
            f"{kp['page_size']} (high-water {kp['high_water']}, "
            f"{kp['allocs']} allocs, {kp['forks']} COW forks)")
    if "prefix_cache" in stats:
        px = stats["prefix_cache"]
        line += (f" | prefix: {px['hits']} hits / {px['misses']} misses "
                 f"({px['hit_tokens']} tokens reused, {px['evictions']} "
                 f"evicted)")
    return line


def build(sc: ServingConfig):
    """(model config, engine) for one serving config."""
    cfg = get_config(sc.arch)
    if sc.use_reduced:
        cfg = reduced(cfg)
    if sc.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=sc.n_layers)
    dtype = getattr(torch, sc.dtype)
    params = init_params(cfg, sc.seed, dtype, device=sc.device)
    runtime = None
    if sc.runtime == "pingpong":
        runtime = DisaggregatedInstance(
            cfg, params, plan=DisaggPlan(n_microbatches=sc.microbatches))
    return cfg, Engine(cfg, params, config=sc, runtime=runtime)


def prompt_maker(sc: ServingConfig, vocab: int, rng):
    """``make_prompt(plen)`` for the workload: with ``shared_prefix_len``
    every prompt opens with the same tokens (the shared-system-prompt
    pattern the radix prefix cache deduplicates), drawn first from
    ``rng``, followed by a per-request random tail."""
    shared = (rng.randint(2, vocab, size=sc.shared_prefix_len).tolist()
              if sc.shared_prefix_len else [])

    def make_prompt(plen: int) -> list:
        if shared:
            if plen <= len(shared):
                raise ValueError(f"prompt_len {plen} must exceed "
                                 f"shared_prefix_len {len(shared)}")
            return shared + rng.randint(2, vocab,
                                        size=plen - len(shared)).tolist()
        return rng.randint(2, vocab, size=plen).tolist()
    return make_prompt


def run(config: Optional[ServingConfig] = None, **overrides) -> dict:
    """Serve one workload; returns the engine's stats for the measured
    requests (``warmup_requests`` are served first and left out)."""
    sc = (ServingConfig(**overrides) if config is None
          else config.with_overrides(**overrides))
    cfg, eng = build(sc)
    rng = np.random.RandomState(sc.seed)
    make_prompt = prompt_maker(sc, cfg.vocab, rng)
    for i in range(sc.warmup_requests):
        eng.submit(Request(rid=-1 - i, prompt=make_prompt(sc.prompt_len or 8),
                           max_new_tokens=2))
    eng.run_until_done()
    pre = eng.stats()
    for i in range(sc.n_requests):
        plen = sc.prompt_len or int(rng.randint(2, sc.max_seq // 4))
        eng.submit(Request(rid=i, prompt=make_prompt(plen),
                           max_new_tokens=sc.max_new))
    if eng.runtime is not None:
        eng.runtime.reset_stage_times()
    t0 = time.perf_counter()
    eng.run_until_done()
    dt = time.perf_counter() - t0
    stats = eng.stats()
    for k in ("tokens", "decode_iters", "prefills", "finished"):
        stats[k] -= pre[k]
    for k in ("prefill_s", "prefills", "transfer_s", "transfer_n", "decode_s",
              "decode_n"):
        stats["phases"][k] -= pre["phases"][k]
    stats["kernel_launches"] = {k: v - pre["kernel_launches"][k]
                                for k, v in stats["kernel_launches"].items()}
    # prefix-cache and page counters are cumulative too (warm-up may seed
    # the radix tree; only the measured requests' hits count)
    if "prefix_cache" in stats:
        px = stats["prefix_cache"]
        for k in ("hits", "misses", "hit_tokens", "evictions", "inserts"):
            px[k] -= pre["prefix_cache"][k]
        tot = px["hits"] + px["misses"]
        px["hit_rate"] = px["hits"] / tot if tot else 0.0
    if "kv_pages" in stats:
        for k in ("allocs", "forks", "released"):
            stats["kv_pages"][k] -= pre["kv_pages"][k]
    stats["wall_s"] = dt
    # serve rate counts prefill and the first tokens it samples; decode
    # rate counts only tokens of decode iterations over their host time
    stats["serve_tok_per_s"] = stats["tokens"] / dt
    stats["decode_tok_per_s"] = ((stats["tokens"] - stats["prefills"])
                                 / max(stats["phases"]["decode_s"], 1e-9))
    if sc.verbose:
        print(f"{cfg.name} x{cfg.n_layers} layers {sc.dtype} [{sc.runtime}] on "
              f"{stats['device']}: served {stats['finished']} requests, "
              f"{stats['tokens']} tokens in {dt:.3f}s "
              f"({stats['serve_tok_per_s']:.2f} tok/s served, "
              f"{stats['decode_tok_per_s']:.2f} tok/s decoding, "
              f"{stats['decode_iters']} decode iters)")
        print(format_phases(stats["phases"]))
        if "kv_pages" in stats:
            print(format_pages(stats))
        if "stages" in stats:
            print(format_stages(stats["stages"]))
        print("kernel launches: " + " ".join(
            f"{k}={v}" for k, v in sorted(stats["kernel_launches"].items())))
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the model to this many layers (0 = full depth)")
    ap.add_argument("--dtype", default="float32", choices=DTYPES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain torch path")
    ap.add_argument("--runtime", default="monolithic", choices=RUNTIMES)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=3)
    ap.add_argument("--kv-layout", default="contiguous", choices=KV_LAYOUTS,
                    help="KV-cache layout: contiguous = one (B, W) ring-"
                         "buffer row per request; paged = block tables "
                         "over a refcounted fixed-size page pool with "
                         "radix prefix reuse")
    ap.add_argument("--page-size", type=int, default=16,
                    help="token slots per KV page (paged layout; must "
                         "divide --max-seq)")
    ap.add_argument("--kv-pool-pages", type=int, default=0,
                    help="page-pool size (0 = auto from max_batch/max_seq)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix prefix cache over the page pool (paged "
                         "layout only)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="workload: every prompt opens with the same N "
                         "tokens (0 = fully random prompts)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="pin every prompt to this length (0 = random)")
    ap.add_argument("--warmup-requests", type=int, default=0)
    run(config=ServingConfig.from_args(ap.parse_args()))


if __name__ == "__main__":
    main()
