#!/usr/bin/env python3
"""Where bf16 tokens part between prefill paths, in one process on the
card: phase 13(b)'s workload (mixtral-8x22b at published width, 4
layers, bf16; 8 requests of 32-token prompts sharing 24 tokens, 32 new
tokens; ping-pong m = 2 with the prefill worker, async KV) served

  * contiguous, the worker prefilling one request a batch (B = 1) and
    eight at once (B = 8);
  * paged with the radix prefix cache after a warm request that
    publishes the shared prefix, so every request is a suffix prefill
    (decode steps over its last 8 tokens), at both batch budgets.

Prints, for each run, the (request, token) where its tokens first part
from the contiguous B = 1 run's.  Run from the root of a checkout on the
card:

    python3 scripts/paged_prefix_numerics.py
"""
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels import ops as _  # noqa: E402,F401  registers kernels
from repro_torch.kernels.cuda_build import build_all  # noqa: E402
from repro_torch.launch.serve import engine_for  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.config import ServingConfig  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("paged_prefix_numerics: runs only on the card")
    build_all()
    print(cs.card_line())
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=cs.MAIN["n_layers"])
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    spec = cs.P13_B
    prompts = cs.prompts_for(spec, cfg.vocab)
    toks = {}
    for layout in ("contiguous", "paged"):
        for chunk in (spec["prompt_len"], 8 * spec["prompt_len"]):
            sc = ServingConfig(max_batch=spec["max_batch"], max_seq=spec["max_seq"],
                               runtime="pingpong", microbatches=spec["microbatches"],
                               kv_layout=layout, page_size=spec["page_size"],
                               verbose=False, device="cuda", prefill_devices=1,
                               transfer="async", prefill_chunk_tokens=chunk)
            eng = engine_for(sc, cfg, params)
            warm = cs.warm_prompt(prompts[0], spec) if layout == "paged" else None
            toks[layout, chunk] = cs.p13_profiled(torch, eng, prompts, spec["max_new"],
                                                  warm=warm)[0]
            px = eng.stats().get("prefix_cache")
            print(f"{layout}, prefill batches of {chunk} tokens"
                  + (f": prefix {px['hits']} hits / {px['misses']} misses" if px else ""))
    want = toks["contiguous", spec["prompt_len"]]
    for (layout, chunk), got in toks.items():
        parted = [(r, next(i for i, (a, b) in enumerate(zip(got[r], want[r])) if a != b))
                  for r in want if got[r] != want[r]]
        print(f"{layout}, batches of {chunk} tokens: parts from contiguous B = 1 at "
              f"(request, token) {parted}")


if __name__ == "__main__":
    main()
