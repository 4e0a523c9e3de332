#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all at once, into ``build/repro_torch_kernels``),
then:

  1. holds each kernel against its plain PyTorch version on the card, at
     the serving path's shapes in bf16 and at small f32 shapes (decode
     attention also at phase 2's monolithic shape), checks that two
     launches of decode attention, of gating dispatch and of the grouped
     matmul on the same inputs agree bit for bit, that the paged kernel
     is bit-identical to decode attention over the same cache (bf16 and
     f32; plain, window, softcap), and times kernel, plain version and
     the nearest single PyTorch call: decode attention at the serving
     step's shape and on a full 256-slot ring at B = 4 and 8 (beside
     ``scaled_dot_product_attention``), gating dispatch at T = 4 and 8
     tokens, and counts with ``torch.profiler`` the device kernels of
     one gating-dispatch call there and in the f32 case at T = 128,
     which must be one, one and two (``dispatch_launches``), gating
     top-k on every gating-dispatch shape's inputs and in f32 at T =
     128 at mixtral's router (experts and counts identical to plain,
     two launches bit-identical, its gates and (token, expert) pairs
     bit-identical to the gating-dispatch call's: one front end; every
     device op of one call counted, ``topk_launches``: one up to 16
     tokens, no memset), gating dispatch's time beside it, the
     grouped matmul at the up and the down projection with each of
     its two strip bodies (beside ``torch.bmm``), and at the benchmark's
     decode micro-batch (M = 64 with its dispatch table: mixtral up and
     down, ~16 live rows an expert; arctic up, 81 of 128 experts live)
     with the live-row body beside the strips forced.  The three serving
     kernels are also held at the row counts of m = 3 micro-batches of
     the 8-row batch (3 and 2), and decode attention at B = 1 (the
     suffix prefill's decode steps).  Gating dispatch's
     placement-table and owner-filter branches are held against the
     plain version in bf16 and f32 at T = 4, 8 and 128 (tables only,
     owner only over padded buckets, both for each of 4 owners, and a
     call whose last token's hash rounds to 1.0), and timed on the
     rebalanced and m2n paths' calls;
  2. serves mixtral-8x22b at full width (2 layers, f32 weights, TF32
     off) in ``pingpong`` (m = 2) and ``monolithic`` mode on the same
     requests, each run with the launch counts set to 0 just before and
     read just after, and requires identical greedy tokens, decode
     attention launched by both paths and the MoE kernels by ping-pong
     only.  Then, under a zipf(1.2) router bias over 4 expert nodes, it
     serves static ping-pong, ping-pong rebalanced every 2 decode
     iterations and m2n with rebalancing, and requires identical greedy
     tokens, at least one rebalance and one replicated expert, and an
     imbalance below the static run's;
  3. serves mixtral-8x22b at full width (4 layers, bf16 weights, f32
     router) through the ``pingpong`` engine (max_batch 8, m = 2, 64 new
     tokens per request), with the kernel launch counts set to 0 just
     before and read just after, and requires every request to finish
     and every kernel of the path to have run.  It prints the serve rate
     (prefill included) and the decode rate (decode tokens over the
     engine's decode phase time);
  4. serves the same bf16 model through the paged KV path: ping-pong
     with a contiguous cache, with a paged cache and no prefix cache,
     and with a paged cache and the radix prefix cache, on prompts that
     share a 24-token system prompt.  Paged tokens must equal the
     contiguous ones, the prefix cache must hit for every request but
     the first, and the pool must end holding only the tree's pages.
     After 16 decode iterations of the prefix-cache run it launches
     ``paged_decode_attention`` on every layer of the engine's live page
     pool and block tables and ``gating_topk`` on layer 0's router input,
     then checks and times both there against their plain versions, and
     requires the paged kernel's output to be bit-identical to
     ``decode_attention`` over the gathered view on every layer;
  5. serves phase 3's bf16 model under the zipf(1.2) router bias over 4
     expert nodes through the rebalanced ping-pong path, static m2n and
     m2n with rebalancing, each with the launch counts set to 0 just before
     and read just after: decode rate, ms per iteration, t_a and t_e,
     transport bytes per kind, a profiled window that counts and times
     the gating-dispatch launches (4 per micro-batch and layer under
     m2n), and one decode step with the placement installed held against
     a static ping-pong runtime (routing compared first, as phase 3).

  6. on phase 3's bf16 model, batch and requests: the micro-batch choice
     of paper eq. 3 from one profiled decode iteration under the
     ``inproc`` and the ``simrdma`` transport (t_a, t_e, t_c and m; m = 2
     where t_c = 0), then serves ping-pong with m = auto (simrdma) and
     prefill on the prefill worker (async), the paged ping-pong engine
     with the prefill worker and the radix prefix cache, and ``--runtime
     disagg``, each with the launch counts and the transport ledger set
     to 0 just before and read just after: decode rate, ms per iteration,
     KV transfer time and hops, prefill batches, every kernel of the path
     launched, and every "kv" hop of the bytes its shape gives (a request
     row, or one page).  One decode step of the m = auto run's runtime,
     at the m it chose, is held against the monolithic decode step on
     the same cache (routing compared first, as phase 3).

  7. the registry: every config but the paper's three at its published
     widths.  In f32 (TF32 off), one period of the block pattern
     (arctic-480b one layer, ~56 GB): 2 requests, 4 greedy decode steps
     through the cache (the kernels), each step's logits within 5e-4 of
     the logits' range of the port's full-sequence pass over the same
     tokens (plain attention, no cache); on qwen2-moe-a2.7b, arctic-480b
     and gemma2-27b the ping-pong engine's tokens equal the monolithic
     engine's.  In bf16 at the depths of ``REGISTRY_RUNS`` (mamba2-1.3b,
     recurrentgemma-2b, whisper-large-v3 and qwen2-moe-a2.7b whole),
     8 requests of 16-token prompts, 32 new tokens, max_batch 8, the
     monolithic engine and, on those three models, ping-pong m = 2, each
     with the launch counts set to 0 just before and read just after:
     decode rate, ms/iter, the device's busy share and ops per iteration,
     launches (decode attention above 0 on every model with
     self-attention, the MoE kernels on the MoE ping-pong runs), one
     ping-pong step held against the monolithic step routing-first (at
     one period of layers and at the served depth), the expert bytes
     read per call against those of the experts holding a token, and
     each model's peak memory (below 80 GB).

  8. the trainer (``launch.train``), f32 with TF32 off.  (a) one train
     step on the card against the same step on the CPU (same params and
     batch) on reduced mixtral-8x22b and qwen2-moe-a2.7b: routing equal,
     loss and aux within 1e-5 relative, every gradient within 1e-4 of
     its leaf's max |g|, the updated params within 1e-5 of their range.
     (b) mixtral-8x22b at its published widths cut to one layer, batch 8
     x seq 128, 10 steps at the JAX launcher's defaults, with the launch
     counts set to 0 just before and required to stay 0 (the kernels
     have no backward; the path reaches none): ms/step, tokens/s,
     forward + backward and update apart, peak memory, loss and grad
     norm per step beside the step's bound; the losses finite and
     falling.  (c) one step at remat "full" against "none" on the same
     params and batch: equal loss, less memory kept for backward.

  9. the multi-process slice, every rank a process on the one card over
     gloo (NCCL refuses two ranks on one device).  (a) mixtral-8x22b's
     MoE layer at published width over 2 ranks, 4 experts each, f32
     (TF32 off) then bf16, T = 4 and 8 in the drop-free capacity mode:
     each rank's y and counts against the plain ``routed_experts_dense``
     of one process (counts exact, f32 within 1e-5 of the output's
     range, bf16 2e-2), every rank launching ``gating_dispatch[owner]``
     once and ``grouped_matmul`` three times per dispatch; per rank the
     device time of dispatch, expert MLP and the combine's
     ``all_reduce`` (CUDA events), the all_reduce on the host clock
     beside the same bytes as a CPU tensor (the host staging), the
     call's wall time, beside the same dispatch as 2 shards in one
     process.  (b) ``repro_torch.launch.dist_smoke --procs 2`` on the
     card.  (c) qwen2-moe-a2.7b at published width cut to one layer,
     f32, batch 8 x seq 128 split 4 + 4 over 2 ranks, 3 data-parallel
     steps against one process on the whole batch: tokens dropped,
     losses and aux within 1e-5 relative, step 0's averaged gradients
     within 1e-4 of max |g|, the step's params by 8(a)'s loose rule;
     ms/step, the gradient all_reduce's share, each rank's peak.  The
     ranks are ``chip_smoke.py --phase9 m2n|dp DIR``; one that fails or
     hangs fails the phase.

 10. the model axis: training on a ("data", "model") grid of processes,
     each rank holding its blocks of the params under the JAX "ep" rules
     and computing tensor- and expert-parallel over "model", f32 with
     TF32 off, batch 8 x seq 128, 3 steps at published width cut to one
     layer, each first in one process on the whole batch (memory freed
     after).  (a) mixtral-8x22b on a (1, 2) grid (23.2 GB of params,
     grads and moments per rank); (b) qwen2-moe-a2.7b on a (2, 2) grid
     (60 experts, EP over 2).  Every rank's losses and aux within 1e-6
     (a) / 1e-5 (b) relative of the one process's, entries dropped in
     every step, each rank's block of step 0's gradients within 1e-5 (a)
     / 1e-4 (b) of each leaf's max |g| of the one-process gradient, and
     no kernel launched (the path has none); ms/step, the model-axis
     collectives' and the data-axis gradient all_reduce's shares (host
     clock), peak memory per rank.  The ranks are ``chip_smoke.py
     --phase10 a|b DIR``, every one on cuda:0 over gloo; with a card per
     rank each takes its own and they meet over NCCL (``chip_smoke.py
     --phase10-only`` runs this phase alone).

 11. serving on a rank's shards: ``prefill`` and greedy ``decode_step``s
     under ``ModelParallel`` on a grid of processes (cuda:0, gloo), each
     rank on its blocks of the params and of the KV cache.  (a)
     mixtral-8x22b on (1, 2): 24 query heads, 4 kv heads and 4 experts a
     rank, the experts as m2n shards over "model" (gating_dispatch's owner
     branch and grouped_matmul in every rank); (b) minitron-4b on (1, 3):
     8 kv heads do not divide 3, so every rank holds all of them on 64 of
     the 192 ring slots and runs decode attention's partial branch, the
     ranks' rows merged by ``merge_partials``.  8 requests, 32 steps, at
     published width: f32 at 2 layers against one process (tokens exact,
     logits within 5e-4 of their range), bf16 at 4 layers fed one
     process's tokens (routing first, then logits within 5% of their
     range: the prefill, and one decode step from one process's cache
     by phase 3's rule); every run's launches equal to those the layers and steps
     predict; ms per decode step beside one process's, the model-axis
     collectives of one step replayed alone, params and peak per rank.
     The partial branch is held against its plain version (f32 1e-5,
     bf16 2e-2) and timed beside SDPA at (b)'s block.  ``chip_smoke.py
     --phase11-only`` runs this phase alone.

 12. every layer kind on a rank's shards (ranks on cuda:0, gloo), each
     run first in one process (its memory freed before the ranks start).
     (a) training on (1, 2), f32, TF32 off, batch 4 x seq 128, 3 steps,
     published widths cut in depth: recurrentgemma-2b one period,
     mamba2-1.3b 2 layers, whisper-large-v3 1 encoder + 1 decoder layer,
     llama-3.2-vision-90b its cross layer (~24 GB of state a rank, last):
     every step's loss within 1e-5 relative of one process's, step 0's
     norm within 1e-5, each rank's block of step 0's gradients within
     1e-5 of each leaf's max |g|, the update of the same gradients on the
     rank's blocks within 1e-5 of each leaf's range, step 0's own params
     by 8(a)'s count, no kernel launched.  (b) serving 8 requests:
     recurrentgemma-2b whole on (1, 4) (RG-LRU width, 10 query heads cut
     mid-head, the local rings' 2048 slots split 4 ways: the partial
     branch at hd 256), mamba2-1.3b and whisper-large-v3 whole
     and llama-3.2-vision-90b at 5 layers on (1, 2): f32 at one period
     (tokens exact, logits within 5e-4 of their range), bf16 fed one
     process's tokens (the prefill, and one step from one process's
     cache, by phase 3's rule); launches as predicted in every rank; ms
     per decode step beside one process's, one step's collectives
     replayed alone, params and peak per rank.  (c) the partial branch at
     q (8, 10, 256) over a (8, 512, 1, 256) block of a wrapped 2048-slot
     ring against its plain version (f32 1e-5, bf16 2e-2, an empty row 0
     and -inf), timed beside SDPA; it joins the kernels line as a second
     shape of ``decode_attention[partial]``.  ``chip_smoke.py
     --phase12-only`` runs this phase alone.

 13. the disaggregated runtime on disjoint ranks of the card (gloo; a
     card per rank: NCCL), mixtral-8x22b at published width cut in depth,
     every rank drawing only what its role keeps, leaf by leaf
     (``launch.serve.draw_for_rank``).  (a) f32, 2 layers, 1 attention +
     4 expert ranks, phase 2's placement workload (zipf(1.2), rebalanced
     every 2 iterations), the dispatch path and then M2N on one runtime:
     tokens equal to phase 2's one process, rebalances, a replicated
     expert, the "weights" hop bytes.  (b) bf16, 4 layers, 1 prefill + 1 attention + 2 expert
     ranks: one decode step against one process's monolithic step by
     phase 3's rule, then 8 requests of 32-token prompts (24 shared)
     contiguous with async KV, paged with the prefix cache on a cold tree
     (tokens equal), and paged after a warm request (8 prefix hits).
     Each rank prints its role, ms per decode iteration (host), t_a /
     t_e (CUDA events), hops sent and waited on, params and peak; the
     profiler counts each rank's decode attention, gating dispatch and
     grouped matmul kernels (``phase13_rank_launches`` in the kernels
     line).  ``chip_smoke.py --phase13-only`` runs this phase alone.

 14. the JAX dry run's other training layouts on a grid of processes
     (cuda:0, gloo; a card per rank: NCCL).  (a) phase 10(b)'s
     qwen2-moe-a2.7b layer (published width, f32, TF32 off, batch 8 x seq
     128, 3 steps) on (2, 2) under fsdp, ep2d, and sequence parallelism,
     m2n2d and m2n with ZeRO-1, in one start of the ranks, each rank drawing
     its blocks leaf by leaf (fsdp and ep2d with ZeRO-1 are JAX's own
     ``DuplicateSpecError`` on this grid, checked).  Each layout against
     its one-process function ("dense": the plain step; "blocks": the
     experts routing each data rank's rows apart, m2n's capacity), run
     first here: losses and aux within 1e-5 relative, the entries
     dropped equal where the experts route the global batch, each rank's
     block of step 0's gradients within 1e-4 of each leaf's max |g| and
     of step 0's params within AdamW's first-step bound (the one-process
     step 0 recomputed one rank at a time), no kernel launched; per rank
     ms/step, each collective kind's share and bytes, params, moments and
     peak.  (b) phase 11(a)'s f32 run (mixtral-8x22b, 2 layers, (1, 2),
     m2n experts) with a sequence-parallel prefill: tokens equal one
     process's, logits within 5e-4 of their range, each kernel's device
     launches (torch.profiler) and host launches as ``p11_predicted``
     says; the prefill's ms and collective bytes by kind beside the same
     prefill without the flag (``phase14_rank_launches`` in the kernels
     line).  ``chip_smoke.py --phase14-only`` runs this phase alone.

Phase 1 also holds the three serving kernels at phase 7's shapes: decode
attention at head_dim 256 with 10 heads on 1 over a wrapped 2048-slot
ring (recurrentgemma-2b), at head_dim 128 with softcap 50 (gemma2-27b)
and head_dim 64 with 20 heads on 20 (whisper-large-v3), the paged kernel
at head_dim 256; gating dispatch and gating top-k at 60 experts top-4
(d 2048) and 128 experts top-2 (d 7168) for T = 4 and 8; the grouped
matmul's up and down projections of both at M = 4.  After phase 3 it
prints the planner's
``attn_time`` / ``expert_time`` at phase 3's shape under its H800 row
beside the measured t_a / t_e.

Phase 2 also serves the paged layout (monolithic and ping-pong, prefix
cache on) on shared-prefix prompts, the prefill worker (monolithic and
ping-pong under sync and async KV transfer, ping-pong at m = 3, and paged
ping-pong with the prefix cache) and ``--runtime disagg`` at m = 2, whose
tokens must all
equal the contiguous monolithic ones, with one "kv" hop per request
(contiguous) or per non-shared page (paged).

Phase 1 ends by requiring every CUDA wrapper to refuse, before any
launch, an input that requires grad.

The ranks of phases 9-14 are forked, a group at a time, from one process
(``chip_smoke.py --rank-forker``) that imported torch and the port's
modules and ran a meta-device draw when the smoke started, so no rank
imports them anew; each runs the entry point its phase names
(``chip_smoke.py --phaseN ...``), which also runs as a process of its
own.  Every rank draws only its blocks of the params (phases 10-14),
leaf by leaf, and phase 13's ranks only what their role keeps.

After the build it prints each kernel's registers, shared memory and
spills from ``nvcc -Xptxas -v``.  Each decode profile (phases 3 and 4)
requires one device kernel per ``gating_dispatch`` call.  Before the
last line it prints the card's name and power limit and a
``{"kernels": [...]}`` line (decode attention, gating top-k, gating
dispatch and the grouped matmul carry a ``shapes`` list, one entry per
timed shape, gating top-k's with gating dispatch's time as
``dispatch_ms``;
``gating_dispatch[tables]`` and ``gating_dispatch[owner]`` are the
kernel's two branches, their launches counted on phase 5's rebalanced
and m2n + rebalanced runs; ``gating_dispatch[owner]`` and
``grouped_matmul`` also carry ``phase9_rank_launches``, each rank's
launches in phase 9(a)); the last line is the contract line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line.  It imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 / f32 rates
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

MAIN = dict(max_batch=8, microbatches=2, max_seq=256, n_requests=8,
            prompt_len=16, max_new=64, n_layers=4)
F32 = dict(max_batch=8, microbatches=2, max_seq=64, n_requests=4,
           prompt_len=32, shared_prefix_len=24, page_size=8, max_new=4,
           n_layers=2)
# phase 4: the JAX package's pingpong_paged / pingpong_prefix_shared
# serve_bench entries (page size 8, 24 of 32 prompt tokens shared) at
# phase 3's width, depth and batch
PAGED = dict(MAIN, prompt_len=32, shared_prefix_len=24, page_size=8)
# phases 2 and 5: live expert placement and m2n over 4 expert nodes under
# a zipf(1.2) router bias, re-solved every 2 decode iterations (the JAX
# package's tests/test_multidevice.py:143-186 setting)
PLACE = dict(expert_nodes=4, zipf=1.2, rebalance_every=2)
PLACE_F32 = dict(F32, shared_prefix_len=0, max_new=8)
# the three engines of the placement phases: (use_m2n, rebalance)
PLACE_RUNS = {"static": (False, False), "rebalanced": (False, True),
              "m2n+rebalanced": (True, True)}
# phase 5's timed runs: the two placement paths, and static m2n beside them
TIMED_RUNS = {"rebalanced": (False, True), "m2n": (True, False),
              "m2n+rebalanced": (True, True)}
LIVE_ITER = 16          # decode iteration at which phase 4 reads the live pool
SPIN_CYCLES = 1_000_000  # device spin before each timed call (~0.5 ms)
SESSIONS = 5            # profiler sessions tried for one dispatch count


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    require(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """(kernel, registers, shared bytes, spill stores, spill loads) for
    each entry function in an ``nvcc -Xptxas -v`` log."""
    rows, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            rows.append((name, int(m.group(1)), int(smem.group(1)) if smem else 0,
                         *spill))
            name, spill = None, (0, 0)
    return rows


def demangle(names):
    """Readable kernel names (``cu++filt`` where the toolkit has it)."""
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        r = subprocess.run([tool], input="\n".join(names), capture_output=True,
                           text=True, timeout=60)
        out = r.stdout.splitlines()
    except OSError:
        out = []
    if len(out) != len(names):
        return list(names)
    return [re.sub(r"\(anonymous namespace\)::|\((int|bool)\)|\(.*\)$", "", n)
            .replace("__nv_bfloat16", "bf16") for n in out]


def time_ms(torch, fn, reps=20, flush=None):
    """Median device time of one call, each call timed with its own CUDA
    events; ``flush`` (a large buffer) is rewritten before every call so
    the call finds its inputs outside L2, as in the decode step.  A spin
    kernel of ~0.5 ms before the start event keeps the device busy while
    the host issues the call, so the time is the device's alone, for the
    kernel and its PyTorch yardstick alike."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_events(torch, prof):
    """The device activity of a profile (kernels, memsets, copies), not
    the device-side ranges of the port's spans (``repro_torch.trace``)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ops(torch, fn, label):
    """The names of the device ops (kernels, memsets, copies) of one call
    ``fn``, recorded by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    # a session that records no device activity at all has not seen the
    # call (CUPTI can miss whole sessions of a process, in runs where the
    # sessions before and after see the device): it is repeated, after a
    # pause, up to SESSIONS times; any session that sees the device decides
    for attempt in range(SESSIONS):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in device_events(torch, prof)]
        if names:
            return names
    raise SmokeFailure(f"{label}: torch.profiler recorded no device activity "
                       f"in {SESSIONS} sessions")


def require_dispatch_kernels(torch, gd_mod, fn, T, label):
    """The device kernels of one gating_dispatch call ``fn`` at T tokens,
    counted by torch.profiler, must be the wrapper's
    ``dispatch_launches(T)``; returns the count."""
    names = device_ops(torch, fn, label)
    n = sum("gating_dispatch" in name for name in names)
    require(n == gd_mod.dispatch_launches(T),
            f"{label}: one call ran {n} gating_dispatch device kernels, "
            f"expected {gd_mod.dispatch_launches(T)} (device events {names})")
    return n


def require_topk_ops(torch, gt_mod, fn, T, label):
    """Every device op of one gating_topk call ``fn`` at T tokens, counted
    by torch.profiler, must be one of its kernels, ``topk_launches(T)`` in
    all (no memset); returns the count."""
    names = device_ops(torch, fn, label)
    require(len(names) == gt_mod.topk_launches(T)
            and all("gating_topk" in name for name in names),
            f"{label}: one call ran the device ops {names}, expected "
            f"{gt_mod.topk_launches(T)} gating_topk kernel(s)")
    return len(names)


def require_same_front_end(torch, label, topk, disp, E):
    """gating_topk's (token, expert) pairs and gates against a
    gating_dispatch call on the same x and router with E buckets, capacity
    T, no bias (no drops): the same pairs, the gates bit for bit."""
    gates, experts, _ = (t.cpu() for t in topk)
    idx, gbuf = disp[0].cpu(), disp[1].cpu()
    T = gates.shape[0]
    want = sorted((int(e), t, float(g)) for t in range(T)
                  for e, g in zip(experts[t].tolist(), gates[t].tolist()))
    got = sorted((e, int(idx[e, c]), float(gbuf[e, c])) for e in range(E)
                 for c in range(idx.shape[1]) if int(idx[e, c]) < T)
    require(got == want, f"{label}: gating_dispatch's buffers do not hold "
            f"gating_topk's pairs and gates bit for bit")


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(torch, name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    require(bool((err <= lim).all()),
            f"{name}: max |err| {float(err.max()):.3e} over tolerance "
            f"(rtol {rtol}, atol {atol})")


def check_topk(torch, name, got, want):
    require(torch.equal(got[1], want[1]), f"{name}: experts differ")
    require(torch.equal(got[2], want[2]), f"{name}: counts differ")
    check_close(torch, f"{name} gates", got[0], want[0], 1e-5, 1e-5)


def paged_pool(torch, gen, k, v, cache_pos, pos, ps):
    """Scatter a dense (B, W) cache into a shuffled pool of B * W / ps
    pages: (k_pages, v_pages, pos_pages, block_table), row b mapping only
    its logical pages up to ``pos[b]``."""
    B, W = cache_pos.shape
    npg = W // ps
    pages = torch.randperm(B * npg, device=k.device, generator=gen).reshape(B, npg)
    owned = torch.arange(npg, device=k.device)[None] <= (pos[:, None] // ps).long()
    table = torch.where(owned, pages, -1).to(torch.int32).contiguous()
    flat = pages.reshape(-1)
    shape = (B * npg, ps) + tuple(k.shape[2:])
    kp, vp = torch.empty(shape, dtype=k.dtype, device=k.device), \
        torch.empty(shape, dtype=v.dtype, device=k.device)
    pp = torch.empty((B * npg, ps), dtype=torch.int32, device=k.device)
    kp[flat], vp[flat] = k.reshape(shape), v.reshape(shape)
    pp[flat] = cache_pos.reshape(B * npg, ps)
    return kp, vp, pp, table


def placement_case(torch, dev, loads, nodes):
    """Device tables of the placement solved for ``loads`` over ``nodes``
    expert nodes under the runtime's slot budget, and that budget S."""
    from repro_torch.core import load_balance as lb
    E = len(loads)
    e_loc = -(-E // nodes)
    S = min(E, max(e_loc, round(e_loc * 2.0)))
    tbl = lb.placement_tables(lb.balance_experts(loads, nodes), S)
    return tbl, S, dict(
        slots_per_node=S,
        rep_node=torch.from_numpy(tbl.rep_node).to(dev),
        rep_slot=torch.from_numpy(tbl.rep_slot).to(dev),
        rep_cum=torch.from_numpy(tbl.rep_cum).to(dev))


def dispatch_branches(torch, dev, gen, flush, randn):
    """Phase 1's placement-table and owner-filter cases of gating_dispatch
    against its plain version: bf16 and f32 at T = 4, 8 and 128 (one and
    two launches), mixtral's router (d 6144, 8 experts, top-2) with a bias
    and 0/1 count weights.  Tables only (4 nodes x 4 slots, hot expert 0
    replicated), owner only (6 experts padded to 8 buckets over 4 shards,
    every owner), tables and owner for each of the 4 owners, and a call
    of 10939237 tokens whose last token's hash rounds to 1.0.  idx_buf
    and counts identical, gates within 1e-5, two launches bit-identical.
    Times the rebalanced path's call (tables) and the m2n paths' calls
    (owner, with and without tables) at T = 4 behind the L2 flush.
    Returns the kernels-line rows of the two variants."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.gating_dispatch import gating_dispatch_plain
    from repro_torch.models import moe as moe_lib
    d, K, N = 6144, 2, 4
    tbl8, S8, tk8 = placement_case(torch, dev, [100.0] + [4.0] * 7, N)
    require(int((tbl8.fractions > 1e-9).sum(1).max()) > 1,
            "phase 1: the hot expert is not replicated")
    routers = {E: randn(d, E, dtype=torch.float32, scale=d ** -0.5) for E in (6, 8)}

    def check(label, x, E, n_buckets, C, **kw):
        kw = dict(kw, bias=torch.linspace(-0.5, 0.5, E, device=dev),
                  count_weights=(torch.arange(x.shape[0], device=dev) % 3 > 0).float())
        got = kops.gating_dispatch(x, routers[E], K, n_buckets, C, **kw)
        again = kops.gating_dispatch(x, routers[E], K, n_buckets, C, **kw)
        want = gating_dispatch_plain(x, routers[E], K, n_buckets, C, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got[0], want[0]), f"{label}: idx_buf differs")
        require(torch.equal(got[2], want[2]), f"{label}: counts differ")
        check_close(torch, f"{label} gates", got[1], want[1], 1e-5, 1e-5)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{label}: two launches on the same inputs differ")
        return max_err(torch, got[1], want[1])

    errs = []
    for dt in (torch.bfloat16, torch.float32):
        for T in (4, 8, 128):
            x = randn(T, d, dtype=dt)
            errs.append(check(f"gating_dispatch tables {dt} T={T}", x, 8, N * S8, T,
                              **tk8))
            for j in range(N):
                errs.append(check(f"gating_dispatch owner {j} {dt} T={T}", x, 6, 8,
                                  T, owner=j, slots_per_node=2))
                errs.append(check(f"gating_dispatch tables+owner {j} {dt} T={T}", x,
                                  8, N * S8, T, owner=j, **tk8))
    print(f"gating_dispatch branches (bf16 and f32, T = 4, 8, 128): tables "
          f"(4 nodes x {S8} slots, expert 0 on {int((tbl8.fractions[0] > 1e-9).sum())} "
          f"nodes), owner (6 experts in 8 buckets, owners 0-3), tables + owner "
          f"(owners 0-3): idx_buf and counts identical, gates max |err| "
          f"{max(errs):.3e}, two launches bit-identical")

    # the token hash of row 10939236 rounds to u = 1.0: its replica of the
    # hot expert is clamped to the last one (x tiny, the router zero, the
    # bias sending every token to expert 0; two launches)
    T, tok = 10939237, 10939236
    require(float(moe_lib.token_hash01(torch.tensor([tok]))[0]) == 1.0,
            "phase 1: token 10939236 does not hash to 1.0")
    tbl4, S4, tk4 = placement_case(torch, dev, [100.0, 1.0, 1.0, 1.0], 2)
    xh = torch.randn(T, 8, device=dev, generator=gen)
    wh = torch.zeros(8, 4, device=dev)
    hk = dict(tk4, bias=torch.tensor([10.0, 0.0, 0.0, 0.0], device=dev))
    got = kops.gating_dispatch(xh, wh, 1, 2 * S4, T, **hk)
    want = gating_dispatch_plain(xh, wh, 1, 2 * S4, T, **hk)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
            "gating_dispatch hash rounding to 1.0: differs from plain")
    last = int(tbl4.rep_node[0, -1]) * S4 + int(tbl4.rep_slot[0, -1])
    filled = int((got[0][last] < T).sum())
    require(int(got[0][last, filled - 1]) == tok,
            "gating_dispatch: the token hashing to 1.0 did not take the last replica")
    print(f"gating_dispatch tables, T = {T} (two launches): token {tok} hashes to "
          f"1.0 and takes the last replica of expert 0 (bucket {last}, slot "
          f"{filled - 1}); idx_buf and counts identical to plain")
    del xh, got, want

    # timing: the call of each path at one serving micro-batch (T = 4, C = 4)
    T = 4
    x = randn(T, d)
    cw = torch.ones(T, device=dev)
    tk_m2n = dict(slots_per_node=2)

    def timed(shape, n_buckets, rows, R, **kw):
        args = (x, routers[8], K, n_buckets, T)
        kw = dict(kw, count_weights=cw)
        got = kops.gating_dispatch(*args, **kw)
        want = gating_dispatch_plain(*args, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
                f"gating_dispatch {shape}: differs from plain")
        nbytes = (x.numel() * 2 + routers[8].numel() * 4 + T * 4 + 3 * 8 * R * 4
                  + 2 * rows * T * 4 + 8 * 4)
        r = dict(shape=shape, err=max_err(torch, got[1], want[1]),
                 ms=time_ms(torch, lambda: kops.gating_dispatch(*args, **kw),
                            flush=flush),
                 plain_ms=time_ms(torch, lambda: gating_dispatch_plain(*args, **kw),
                                  flush=flush),
                 library_ms=None, bound=bound_ms(nbytes, 2 * T * d * 8, "float32"))
        print(f"gating_dispatch {shape}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound'][0]:.6f} ms")
        return r

    R = tbl8.rep_node.shape[1]
    t_tables = timed(f"tables: x ({T},{d}) bf16, 8 experts, top-2, {N} nodes x "
                     f"{S8} slots (R = {R}), C = {T}", N * S8, N * S8, R, **tk8)
    t_both = timed(f"owner 0 + tables: x ({T},{d}) bf16, {N} nodes x {S8} slots, "
                   f"C = {T}", N * S8, S8, R, owner=0, **tk8)
    t_owner = timed(f"owner 0: x ({T},{d}) bf16, 8 experts over {N} shards, "
                    f"C = {T}", 8, 2, 0, owner=0, **tk_m2n)
    src = "src/repro/kernels/gating_topk.py:255"
    return {"gating_dispatch[tables]": dict(t_tables, shapes=[t_tables], replaces=src),
            "gating_dispatch[owner]": dict(t_both, shapes=[t_both, t_owner],
                                           replaces=src)}


# ----------------------------------------------------------------- phase 1
def phase_kernels(torch, dev):
    from repro_torch.kernels import gating_dispatch as gd_mod
    from repro_torch.kernels import gating_topk as gt_mod
    from repro_torch.kernels import grouped_matmul as gm_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.gating_dispatch import gating_dispatch_plain
    from repro_torch.kernels.gating_topk import gating_topk_plain
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.attention import decode_attention as attn_plain
    from repro_torch.models.attention import paged_decode_attention as paged_plain
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(dtype)

    # a second of device work first, so the timings below find the card
    # at its working clocks
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(20):
            flush.zero_()
        torch.cuda.synchronize()

    # -- decode attention: one micro-batch of the serving path (B = 4 of
    # max_batch 8 at m = 2; mixtral 48 heads / 8 kv heads, hd 128; the
    # ring is max_seq wide, filled up to the query position 40)
    B, H, Hkv, hd, W, P = MAIN["max_batch"] // 2, 48, 8, 128, MAIN["max_seq"], 40
    q, k, v = randn(B, H, hd), randn(B, W, Hkv, hd), randn(B, W, Hkv, hd)
    cpos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    cpos[:, :P + 1] = torch.arange(P + 1, dtype=torch.int32, device=dev)
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    args = (q, k, v, cpos, pos)
    got, want = kops.decode_attention(*args), attn_plain(*args)
    torch.cuda.synchronize()
    # bf16: the kernel and the plain version both reduce in f32 and round
    # the output once to bf16 (relative step 2**-8) -> 2e-2
    check_close(torch, "decode_attention bf16", got, want, 2e-2, 2e-2)
    valid = int(((cpos >= 0) & (cpos <= pos[:, None])).sum())
    require(torch.equal(got, kops.decode_attention(*args)),
            "decode_attention: two launches on the same inputs differ")

    def attn_shape(label, args, window=0, attn_softcap=0.0):
        """Kernel, plain and SDPA times of one decode-attention shape (no
        SDPA with a softcap: no PyTorch call computes that function)."""
        q, k, v, cpos, pos = args
        Hq, hq = q.shape[1], q.shape[2]
        Hk = k.shape[2]
        ok = (cpos >= 0) & (cpos <= pos[:, None])
        if window:
            ok &= cpos > pos[:, None] - window
        mask = ok[:, None, None, :]
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        valid = int(ok.sum())
        es = q.element_size()
        nbytes = (2 * q.numel() * es + valid * Hk * hq * 2 * es + cpos.numel() * 4
                  + pos.numel() * 4)
        kw = dict(window=window, attn_softcap=attn_softcap)
        got = kops.decode_attention(*args, **kw)
        lib = (None if attn_softcap else time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush))
        r = dict(shape=label, err=max_err(torch, got, attn_plain(*args, **kw)),
                 ms=time_ms(torch, lambda: kops.decode_attention(*args, **kw),
                            flush=flush),
                 plain_ms=time_ms(torch, lambda: attn_plain(*args, **kw), flush=flush),
                 library_ms=lib, bound=bound_ms(nbytes, 4 * valid * Hq * hq, "bfloat16"))
        print(f"decode_attention {label}: {r['ms']:.4f} ms, sdpa "
              f"{'null' if lib is None else f'{lib:.4f} ms'}, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms, max |err| "
              f"{r['err']:.3e}")
        return r

    shapes = [attn_shape(f"q {tuple(q.shape)} ring {tuple(k.shape)}, "
                         f"{valid} valid slots", args)]
    # the full ring: every one of the max_seq slots valid, at B = 4 and 8
    for Bf in (B, MAIN["max_batch"]):
        fargs = (randn(Bf, H, hd), randn(Bf, W, Hkv, hd), randn(Bf, W, Hkv, hd),
                 torch.arange(W, dtype=torch.int32, device=dev).repeat(Bf, 1),
                 torch.full((Bf,), W - 1, dtype=torch.int32, device=dev))
        check_close(torch, f"decode_attention bf16 full ring B={Bf}",
                    kops.decode_attention(*fargs), attn_plain(*fargs), 2e-2, 2e-2)
        shapes.append(attn_shape(f"q {tuple(fargs[0].shape)} full ring "
                                 f"{tuple(fargs[1].shape)}", fargs))
    rows["decode_attention"] = dict(
        shapes[0], shapes=shapes, replaces="src/repro/kernels/decode_attention.py:85")
    # the other row counts of the serving paths: B = 3 and 2 (m = 3
    # micro-batches of the 8-row batch) and B = 1 (the prefix-cache
    # suffix prefill's decode steps on one request row, at the last
    # prompt position)
    for Bs, Ps in ((3, P), (2, P), (1, PAGED["prompt_len"] - 1)):
        cs = torch.arange(W, dtype=torch.int32, device=dev).repeat(Bs, 1)
        cs[cs > Ps] = -1
        sargs = (randn(Bs, H, hd), randn(Bs, W, Hkv, hd), randn(Bs, W, Hkv, hd), cs,
                 torch.full((Bs,), Ps, dtype=torch.int32, device=dev))
        got = kops.decode_attention(*sargs)
        want = attn_plain(*sargs)
        check_close(torch, f"decode_attention bf16 B={Bs}", got, want, 2e-2, 2e-2)
        print(f"decode_attention bf16 q {tuple(sargs[0].shape)} ring "
              f"{tuple(sargs[1].shape)}, {Ps + 1} valid slots per row: max |err| "
              f"{max_err(torch, got, want):.3e}")
    # f32 small shape: window, softcap, ragged W, GQA rep 4
    qf, kf, vf = (randn(2, 8, 64, dtype=torch.float32),
                  randn(2, 37, 2, 64, dtype=torch.float32),
                  randn(2, 37, 2, 64, dtype=torch.float32))
    cf = torch.arange(37, dtype=torch.int32, device=dev).repeat(2, 1)
    cf[:, ::7] = -1
    pf = torch.tensor([30, 36], dtype=torch.int32, device=dev)
    for kw in (dict(window=9), dict(attn_softcap=20.0), {}):
        # f32: same math in another order (and libm expf) -> 1e-4
        check_close(torch, f"decode_attention f32 {kw}",
                    kops.decode_attention(qf, kf, vf, cf, pf, **kw),
                    attn_plain(qf, kf, vf, cf, pf, **kw), 1e-4, 1e-4)
    # f32 at phase 2's monolithic decode_step shape (all max_batch rows,
    # the max_seq-wide ring, hd 128), each row at its own position.
    # Phase 2's two modes both run this kernel, so their token parity
    # cannot judge it: this comparison does
    Bm, Wm = F32["max_batch"], F32["max_seq"]
    qm = randn(Bm, H, hd, dtype=torch.float32)
    km = randn(Bm, Wm, Hkv, hd, dtype=torch.float32)
    vm = randn(Bm, Wm, Hkv, hd, dtype=torch.float32)
    pm = F32["prompt_len"] + torch.arange(Bm, dtype=torch.int32, device=dev)
    cm = torch.arange(Wm, dtype=torch.int32, device=dev).repeat(Bm, 1)
    cm[cm > pm[:, None]] = -1
    got, want = kops.decode_attention(qm, km, vm, cm, pm), attn_plain(qm, km, vm, cm, pm)
    check_close(torch, "decode_attention f32 at the monolithic shape", got, want,
                1e-4, 1e-4)
    print(f"decode_attention f32 {tuple(qm.shape)} cache {tuple(km.shape)}: "
          f"max |err| {max_err(torch, got, want):.3e}")

    # -- paged decode attention: the same micro-batch shape read through
    # block tables from a shuffled pool of 8-slot pages (phase 4's page
    # size), each row at its own position owning only the pages up to it
    # (the rest of its table -1, the pages behind them holding another
    # row's data).  Held against its plain version, and bit for bit against
    # the dense kernel over the same cache (one split plan, one kernel
    # body), in bf16 and in f32
    ps = PAGED["page_size"]
    pq = torch.randint(ps // 2, W, (B,), device=dev, generator=gen,
                       dtype=torch.int32)
    pcp = torch.arange(W, dtype=torch.int32, device=dev).repeat(B, 1)
    pcp[pcp > pq[:, None]] = -1
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        pk_, pv_ = randn(B, W, Hkv, hd, dtype=dt), randn(B, W, Hkv, hd, dtype=dt)
        pages = paged_pool(torch, gen, pk_, pv_, pcp, pq, ps)
        qp = randn(B, H, hd, dtype=dt)
        for kw in ({}, dict(window=40), dict(attn_softcap=30.0)):
            got = kops.paged_decode_attention(qp, *pages, pq, **kw)
            want = paged_plain(qp, *pages, pq, **kw)
            dense = kops.decode_attention(qp, pk_, pv_, pcp, pq, **kw)
            torch.cuda.synchronize()
            check_close(torch, f"paged_decode_attention {dt} {kw}", got, want,
                        tol, tol)
            require(torch.equal(got, dense),
                    f"paged_decode_attention {dt} {kw}: not bit-identical to "
                    f"decode_attention over the same cache (max |diff| "
                    f"{max_err(torch, got, dense):.3e})")
        print(f"paged_decode_attention {dt} q {tuple(qp.shape)} pool "
              f"{tuple(pages[0].shape)} table {tuple(pages[3].shape)}: max |err| "
              f"{max_err(torch, got, want):.3e} vs plain; bit-identical to "
              f"decode_attention (plain, window, softcap)")

    # -- gating_dispatch: the serving path's call for one micro-batch of
    # router inputs (T = 4 tokens, d 6144, 8 experts, top-2, capacity C =
    # T in capacity_mode "full", no router bias, the live-row count
    # weights), and at T = 8 (one micro-batch of max_batch 16)
    T, d, E, K = B, 6144, 8, 2
    wr = randn(d, E, dtype=torch.float32, scale=d ** -0.5)

    topk_shapes = []

    def topk_shape(x, wr, K, disp, model=None):
        """gating_topk on a gating_dispatch shape's inputs: experts and
        counts identical to plain, gates within 1e-5 (f32 sums), two
        launches bit-identical and bit-identical in gates and (token,
        expert) pairs to the dispatch call ``disp`` (E buckets, C = T), its
        device ops counted by the profiler; timed behind the L2 flush.
        Appends its row to ``topk_shapes``."""
        T, d = x.shape
        E = wr.shape[1]
        got, again = kops.gating_topk(x, wr, K), kops.gating_topk(x, wr, K)
        want = gating_topk_plain(x, wr, K)
        torch.cuda.synchronize()
        label = f"gating_topk x ({T},{d}) {str(x.dtype).split('.')[-1]}, {E} experts"
        check_topk(torch, label, got, want)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{label}: two launches on the same inputs differ")
        require_same_front_end(torch, label, got, disp, E)
        n = require_topk_ops(torch, gt_mod, lambda: kops.gating_topk(x, wr, K), T, label)
        r = dict(shape=f"x ({T},{d}) {str(x.dtype).split('.')[-1]}, {E} experts, "
                       f"top-{K} ({n} device op{'s' if n > 1 else ''} per call, "
                       f"profiled)",
                 err=max_err(torch, got[0], want[0]),
                 ms=time_ms(torch, lambda: kops.gating_topk(x, wr, K), flush=flush),
                 plain_ms=time_ms(torch, lambda: gating_topk_plain(x, wr, K),
                                  flush=flush),
                 library_ms=None,
                 dispatch_ms=time_ms(torch, lambda: kops.gating_dispatch(x, wr, K, E, T),
                                     flush=flush),
                 bound=bound_ms(x.numel() * x.element_size() + wr.numel() * 4
                                + T * K * 8 + E * 4, 2 * T * d * E, "float32"))
        if model is not None:
            r["model"] = model
        print(f"gating_topk {r['shape']}: {r['ms']:.4f} ms (gating_dispatch "
              f"{r['dispatch_ms']:.4f} ms on the same inputs), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms; experts and "
              f"counts identical, gates max |err| {r['err']:.3e}, two launches "
              f"bit-identical, pairs and gates bit-identical to gating_dispatch's")
        topk_shapes.append(r)

    def dispatch_shape(T, wr=wr, K=K, model=None):
        d, E = wr.shape
        x = randn(T, d)
        gk = dict(count_weights=torch.ones(T, device=dev))
        got = kops.gating_dispatch(x, wr, K, E, T, **gk)
        again = kops.gating_dispatch(x, wr, K, E, T, **gk)
        want = gating_dispatch_plain(x, wr, K, E, T, **gk)
        torch.cuda.synchronize()
        probs = moe_lib.route(x, wr, K).probs.sort(dim=-1, descending=True).values
        margin = float((probs[:, K - 1] - probs[:, K]).min())
        # the slot build must be identical; gates are f32 sums -> 1e-5
        require(torch.equal(got[0], want[0]), f"gating_dispatch T={T}: idx_buf differs")
        require(torch.equal(got[2], want[2]), f"gating_dispatch T={T}: counts differ")
        check_close(torch, f"gating_dispatch T={T} gates", got[1], want[1], 1e-5, 1e-5)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"gating_dispatch T={T}: two launches on the same inputs differ")
        n = require_dispatch_kernels(
            torch, gd_mod, lambda: kops.gating_dispatch(x, wr, K, E, T, **gk), T,
            f"gating_dispatch T={T}")
        nbytes = x.numel() * 2 + wr.numel() * 4 + T * 4 + 2 * E * T * 4 + E * 4
        r = dict(shape=f"x ({T},{d}) bf16, {E} experts, top-{K}, C = {T} "
                       f"({n} device kernel{'s' if n > 1 else ''} per call, "
                       f"profiled)",
                 err=max_err(torch, got[1], want[1]),
                 ms=time_ms(torch, lambda: kops.gating_dispatch(x, wr, K, E, T, **gk),
                            flush=flush),
                 plain_ms=time_ms(torch, lambda: gating_dispatch_plain(
                     x, wr, K, E, T, **gk), flush=flush),
                 library_ms=None,
                 bound=bound_ms(nbytes, 2 * T * d * E, "float32"))
        if model is not None:
            r["model"] = model
        print(f"gating_dispatch {r['shape']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms; idx_buf and "
              f"counts identical, gates max |err| {r['err']:.3e}, two launches "
              f"bit-identical; smallest top-{K} probability margin {margin:.3e}")
        topk_shape(x, wr, K, got, model)
        return r, x

    (r4, x), (r8, _) = dispatch_shape(T), dispatch_shape(2 * T)
    # the m = 3 micro-batches' token counts
    for Ts in (3, 2):
        xt, gk = randn(Ts, d), dict(count_weights=torch.ones(Ts, device=dev))
        got = kops.gating_dispatch(xt, wr, K, E, Ts, **gk)
        want = gating_dispatch_plain(xt, wr, K, E, Ts, **gk)
        require(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
                f"gating_dispatch T={Ts}: idx_buf or counts differ")
        check_close(torch, f"gating_dispatch T={Ts} gates", got[1], want[1], 1e-5, 1e-5)
        print(f"gating_dispatch x ({Ts},{d}) bf16, C = {Ts}: idx_buf and counts "
              f"identical, gates max |err| {max_err(torch, got[1], want[1]):.3e}")
    shapes = [r4, r8]
    rows["gating_dispatch"] = dict(
        shapes[0], shapes=shapes, replaces="src/repro/kernels/gating_topk.py:255")
    # f32 small shape with drops, bias and weights (T*K = 256 >> E*C = 32),
    # over 8 token tiles of the cluster kernel and the slot kernel
    xs = randn(128, 32, dtype=torch.float32)
    ws = randn(32, 4, dtype=torch.float32)
    kw = dict(bias=torch.linspace(-1, 1, 4, device=dev),
              count_weights=(torch.arange(128, device=dev) % 2).float())
    g2, w2 = kops.gating_dispatch(xs, ws, 2, 4, 8, **kw), \
        gating_dispatch_plain(xs, ws, 2, 4, 8, **kw)
    require(torch.equal(g2[0], w2[0]) and torch.equal(g2[2], w2[2]),
            "gating_dispatch f32: idx_buf or counts differ")
    check_close(torch, "gating_dispatch f32 gates", g2[1], w2[1], 1e-5, 1e-5)
    require(all(torch.equal(a, b) for a, b in zip(
        g2, kops.gating_dispatch(xs, ws, 2, 4, 8, **kw))),
        "gating_dispatch f32: two launches on the same inputs differ")
    n = require_dispatch_kernels(
        torch, gd_mod, lambda: kops.gating_dispatch(xs, ws, 2, 4, 8, **kw), 128,
        "gating_dispatch f32 T=128")
    print(f"gating_dispatch f32 x {tuple(xs.shape)}, 4 experts, top-2, C = 8 "
          f"({n} device kernels per call, profiled), bias and weights: "
          f"idx_buf and counts identical, two launches bit-identical")
    rows.update(dispatch_branches(torch, dev, gen, flush, randn))

    # -- gating_topk: held and timed above on each gating_dispatch shape;
    # here the two-launch path (T = 128, 8 clusters and the counts
    # launch) in f32 at mixtral's router and at the small f32 shape with
    # top-3
    xf = randn(128, d, dtype=torch.float32)
    topk_shape(xf, wr, K, kops.gating_dispatch(xf, wr, K, E, 128))
    check_topk(torch, "gating_topk f32 top-3", kops.gating_topk(xs, ws, 3),
               gating_topk_plain(xs, ws, 3))
    rows["gating_topk"] = dict(topk_shapes[0], shapes=topk_shapes,
                               replaces="src/repro/kernels/gating_topk.py:89")

    # -- grouped_matmul: the expert phase's GEMMs for one micro-batch (8
    # experts, M = C = 4 rows) in bf16: the up projections w1 / w3
    # (6144 -> 16384) and the down projection w2 (16384 -> 6144), each
    # with the body the wrapper picks and with both bodies forced
    G, M, N = E, T, 16384
    xe, he = randn(G, M, d), randn(G, M, N)
    w1 = randn(G, d, N, scale=d ** -0.5)
    w3, w2 = randn(G, d, N, scale=d ** -0.5), randn(G, N, d, scale=N ** -0.5)

    def gm_shape(label, a, b):
        got, want = kops.grouped_matmul(a, b), grouped_matmul_plain(a, b)
        torch.cuda.synchronize()
        check_close(torch, f"grouped_matmul bf16 {label}", got, want, 2e-2, 2e-2)
        require(torch.equal(got, kops.grouped_matmul(a, b)),
                f"grouped_matmul {label}: two launches on the same inputs differ")
        g_, m_, k_ = a.shape
        n_ = b.shape[2]
        r = dict(shape=f"{label} {tuple(a.shape)} @ {tuple(b.shape)}",
                 err=max_err(torch, got, want),
                 ms=time_ms(torch, lambda: kops.grouped_matmul(a, b), flush=flush),
                 plain_ms=time_ms(torch, lambda: grouped_matmul_plain(a, b), reps=5,
                                  flush=flush),
                 library_ms=time_ms(torch, lambda: torch.bmm(a, b), flush=flush),
                 bound=bound_ms((a.numel() + b.numel() + g_ * m_ * n_) * 2,
                                2 * g_ * m_ * k_ * n_, "bfloat16"))
        for body in ("fma", "mma"):
            check_close(torch, f"grouped_matmul bf16 {label} body {body}",
                        gm_mod.grouped_matmul(a, b, body=body), want, 2e-2, 2e-2)
            r[f"{body}_ms"] = time_ms(torch, lambda: gm_mod.grouped_matmul(
                a, b, body=body), flush=flush)
        print(f"grouped_matmul {r['shape']}: {r['ms']:.4f} ms (fma {r['fma_ms']:.4f}, "
              f"mma {r['mma_ms']:.4f}), torch.bmm {r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms, plain {r['plain_ms']:.4f} ms, max |err| "
              f"{r['err']:.3e}")
        return r

    shapes = [gm_shape("up", xe, w1), gm_shape("down", he, w2)]
    rows["grouped_matmul"] = dict(
        shapes[0], shapes=shapes, replaces="src/repro/kernels/grouped_matmul.py:56")
    # the m = 3 micro-batches' capacities, M = C = 3 and 2, with the body
    # the wrapper picks
    for Ms in (3, 2):
        for label, a, b in (("up", xe[:, :Ms], w1), ("down", he[:, :Ms], w2)):
            a = a.contiguous()
            got, want = kops.grouped_matmul(a, b), grouped_matmul_plain(a, b)
            check_close(torch, f"grouped_matmul bf16 {label} M={Ms}", got, want,
                        2e-2, 2e-2)
            print(f"grouped_matmul bf16 {label} {tuple(a.shape)} @ {tuple(b.shape)}: "
                  f"max |err| {max_err(torch, got, want):.3e}")
    for shape in ((3, 17, 130, 257), (2, 1, 64, 8)):
        g_, m_, k_, n_ = shape
        a_, b_ = randn(g_, m_, k_, dtype=torch.float32), randn(
            g_, k_, n_, dtype=torch.float32)
        # f32: f32 FMA against f32 einsum, another summation order -> 1e-4
        check_close(torch, f"grouped_matmul f32 {shape}",
                    kops.grouped_matmul(a_, b_), grouped_matmul_plain(a_, b_),
                    1e-4, 1e-4)

    # -- the composed grouped MLP against the card's copy bandwidth
    mlp_ms = time_ms(torch, lambda: kops.grouped_mlp(xe, w1, w3, w2), reps=10)
    check_close(torch, "grouped_mlp bf16", kops.grouped_mlp(xe, w1, w3, w2),
                kops.grouped_mlp_plain(xe, w1, w3, w2), 3e-2, 3e-2)
    big = torch.empty(2 * 2 ** 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(big)
    copy_ms = time_ms(torch, lambda: dst.copy_(big), reps=10)
    copy_bw = 2 * big.numel() / (copy_ms / 1e3)
    mlp_bytes = 3 * w1.numel() * 2
    print(f"grouped_mlp: {mlp_bytes / 1e9:.3f} GB of expert weights in "
          f"{mlp_ms:.3f} ms = {mlp_bytes / (mlp_ms / 1e3) / 1e9:.1f} GB/s; "
          f"device copy {copy_bw / 1e9:.1f} GB/s (read + write)")
    del big, dst
    # the benchmark's decode micro-batch: 64 tokens top-2 over 8 experts
    g8, counts = torch.Generator().manual_seed(8), [0] * G
    for _ in range(64):
        for e in torch.randperm(G, generator=g8)[:2].tolist():
            counts[e] += 1
    shapes += [gm_decode_shape(torch, "decode up", w1, counts, flush),
               gm_decode_shape(torch, "decode down", w2, counts, flush)]
    del w1, w2, w3, xe, he
    registry_kernel_shapes(torch, dev, gen, flush, randn, rows, attn_shape,
                           dispatch_shape, gm_shape)
    del flush
    check_grad_guard(torch, dev)
    return rows


def grad_guard_calls(torch, dev):
    """One call per CUDA wrapper, by name, with an input that requires
    grad (also run by ``tests/test_torch_kernels.py``)."""
    from repro_torch.kernels import ops as kops
    r = lambda *s, g=False: torch.randn(*s, device=dev).requires_grad_(g)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
    calls = {
        "decode_attention": lambda: kops.decode_attention(
            r(1, 8, 64, g=True), r(1, 32, 8, 64), r(1, 32, 8, 64),
            torch.arange(32, dtype=torch.int32, device=dev)[None], i32(31)),
        "paged_decode_attention": lambda: kops.paged_decode_attention(
            r(1, 8, 64), r(2, 8, 8, 64, g=True), r(2, 8, 8, 64),
            torch.arange(16, dtype=torch.int32, device=dev).view(2, 8),
            i32(0, 1)[None], i32(15)),
        "gating_topk": lambda: kops.gating_topk(r(2, 64), r(64, 8, g=True), 2),
        "gating_dispatch": lambda: kops.gating_dispatch(r(2, 64, g=True), r(64, 8),
                                                        2, 8, 2),
        "grouped_matmul": lambda: kops.grouped_matmul(r(2, 4, 64),
                                                      r(2, 64, 32, g=True)),
    }
    return calls


def check_grad_guard(torch, dev):
    """The kernels have no backward: every CUDA wrapper must raise, and
    launch nothing, when an input requires grad while grad mode is on
    (the training path never reaches them)."""
    from repro_torch.kernels.cuda_build import launch_counts
    calls = grad_guard_calls(torch, dev)
    before = launch_counts()
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            require("no backward" in str(e), f"{name}: {e}")
        else:
            raise SmokeFailure(f"{name}: an input that requires grad was accepted")
    require(launch_counts() == before, "the refused calls launched a kernel")
    print(f"phase 1: {len(calls)} CUDA wrappers refuse an input that requires grad")


def ring_positions(torch, dev, B, W, P):
    """(cache_pos (B, W), pos (B,)) of a ring of W slots written through
    position P[b] of row b: slot w holds the newest position p <= P[b]
    with p % W == w (a ring that has wrapped when P[b] >= W)."""
    pos = torch.tensor(P, dtype=torch.int32, device=dev)
    w = torch.arange(W, dtype=torch.int32, device=dev)[None]
    cpos = pos[:, None] - torch.remainder(pos[:, None] - w, W)
    return torch.where(cpos >= 0, cpos, -1).to(torch.int32).contiguous(), pos


def gm_decode_shape(torch, label, w, counts, flush):
    """``grouped_matmul`` at a decode micro-batch of 64 tokens top-2 (the
    benchmark's M = C = 64 in capacity mode "full"): expert e holds
    counts[e] routed tokens in its first slots, the rest are sentinel
    slots (zeros in x, as gather_tokens fills them).  The live-row body
    with the dispatch table is held against the plain version and against
    itself, and timed beside the tensor-core strips forced (no table: the
    launch before the live-row body); the bound is the bytes the routed
    tokens need (the weights of the experts that hold one, the routed rows
    in and out)."""
    from repro_torch.kernels import grouped_matmul as gm_mod
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
    G, K, N = w.shape
    T = 64
    gen = torch.Generator().manual_seed(G * K)
    idx = torch.full((G, T), T, dtype=torch.int32)
    for e, c in enumerate(counts):
        idx[e, :c] = torch.randperm(T, generator=gen)[:c].int()
    idx = idx.to(w.device)
    x = torch.randn(G, T, K, device=w.device, dtype=torch.bfloat16)
    x.mul_((idx != T)[..., None])
    kw = dict(idx=idx, n_tokens=T)
    n0 = gm_mod.KERNEL.variant_launches["wgmma"]
    got = gm_mod.grouped_matmul(x, w, **kw)
    require(gm_mod.KERNEL.variant_launches["wgmma"] == n0 + 1,
            f"grouped_matmul {label}: M = 64 did not take the live-row body")
    want = grouped_matmul_plain(x, w, **kw)
    torch.cuda.synchronize()
    check_close(torch, f"grouped_matmul bf16 {label}", got, want, 2e-2, 2e-2)
    require(torch.equal(got, gm_mod.grouped_matmul(x, w, **kw)),
            f"grouped_matmul {label}: two launches on the same inputs differ")
    hit, routed = sum(c > 0 for c in counts), sum(counts)
    r = dict(shape=f"{label} {tuple(x.shape)} @ {tuple(w.shape)}, {hit} of {G} experts "
                   f"live, {routed} routed rows",
             err=max_err(torch, got, want),
             ms=time_ms(torch, lambda: gm_mod.grouped_matmul(x, w, **kw), flush=flush),
             mma_ms=time_ms(torch, lambda: gm_mod.grouped_matmul(x, w, body="mma"),
                            flush=flush),
             bound=bound_ms(2 * (hit * K * N + routed * (K + N)), 2 * routed * K * N,
                            "bfloat16"))
    print(f"grouped_matmul {r['shape']}: live-row body {r['ms']:.4f} ms, mma strips "
          f"{r['mma_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
          f"({100 * r['bound'][0] / r['ms']:.1f}%), max |err| {r['err']:.3e}")
    del x, idx, got, want
    return r


def registry_kernel_shapes(torch, dev, gen, flush, randn, rows, attn_shape,
                           dispatch_shape, gm_shape):
    """Phase 1 at the shapes phase 7's models give the three serving
    kernels, each held against its plain version and timed (appended to
    the kernels' ``shapes``): decode attention in bf16 at head_dim 256
    with rep 10 over a wrapped 2048-slot ring (recurrentgemma-2b's local
    layers), head_dim 128 with rep 2 and softcap 50 (gemma2-27b) and
    head_dim 64 with rep 1 (whisper-large-v3), the paged kernel at head
    dim 256; gating dispatch (and gating top-k on its inputs) at 60
    experts top-4, d 2048 (qwen2-moe) and 128 experts top-2, d 7168
    (arctic) for T = 4 and 8; the grouped
    matmul's up and down projections of both at one micro-batch of the
    8-row batch (M = C = 4)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import decode_attention as attn_plain
    from repro_torch.models.attention import paged_decode_attention as paged_plain
    B = 8
    # recurrentgemma-2b: 10 heads on 1 kv head, hd 256, window 2048; each
    # row past the ring's first wrap, every slot valid
    W = 2048
    cpos, pos = ring_positions(torch, dev, B, W, [W + 37 + 100 * b for b in range(B)])
    args = (randn(B, 10, 256), randn(B, W, 1, 256), randn(B, W, 1, 256), cpos, pos)
    check_close(torch, "decode_attention bf16 hd 256 wrapped ring",
                kops.decode_attention(*args, window=W),
                attn_plain(*args, window=W), 2e-2, 2e-2)
    rg = attn_shape(f"q {tuple(args[0].shape)} wrapped ring {tuple(args[1].shape)}, "
                    f"window {W} (recurrentgemma-2b)", args, window=W)
    rg["model"] = "recurrentgemma-2b"
    # gemma2-27b: 32 heads on 16, hd 128, softcap 50, a 256-slot ring to 200
    cpos, pos = ring_positions(torch, dev, B, 256, [200] * B)
    args = (randn(B, 32, 128), randn(B, 256, 16, 128), randn(B, 256, 16, 128),
            cpos, pos)
    check_close(torch, "decode_attention bf16 softcap 50",
                kops.decode_attention(*args, attn_softcap=50.0),
                attn_plain(*args, attn_softcap=50.0), 2e-2, 2e-2)
    gm2 = attn_shape(f"q {tuple(args[0].shape)} ring {tuple(args[1].shape)} to 200, "
                     f"softcap 50 (gemma2-27b)", args, attn_softcap=50.0)
    gm2["model"] = "gemma2-27b"
    # whisper-large-v3: 20 heads on 20, hd 64
    args = (randn(B, 20, 64), randn(B, 256, 20, 64), randn(B, 256, 20, 64), cpos, pos)
    check_close(torch, "decode_attention bf16 hd 64 rep 1",
                kops.decode_attention(*args), attn_plain(*args), 2e-2, 2e-2)
    wh = attn_shape(f"q {tuple(args[0].shape)} ring {tuple(args[1].shape)} to 200 "
                    f"(whisper-large-v3)", args)
    wh["model"] = "whisper-large-v3"
    rows["decode_attention"]["shapes"] += [rg, gm2, wh]
    # f32 at hd 256: a window, partly filled rows, rep 10 -> 1e-4 (as the
    # f32 small shape of phase 1)
    cf, pf = ring_positions(torch, dev, 2, 300, [150, 420])
    af = (randn(2, 10, 256, dtype=torch.float32), randn(2, 300, 1, 256, dtype=torch.float32),
          randn(2, 300, 1, 256, dtype=torch.float32), cf, pf)
    for kw in (dict(window=64), dict(attn_softcap=20.0), {}):
        check_close(torch, f"decode_attention f32 hd 256 {kw}",
                    kops.decode_attention(*af, **kw), attn_plain(*af, **kw), 1e-4, 1e-4)
    # the paged kernel shares the body: hd 256 over a shuffled pool of
    # 8-slot pages, against its plain version and bit for bit against
    # decode_attention over the same cache
    W, ps = 64, 8
    pq = torch.tensor([20, 63], dtype=torch.int32, device=dev)
    pcp = torch.arange(W, dtype=torch.int32, device=dev).repeat(2, 1)
    pcp[pcp > pq[:, None]] = -1
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        pk_, pv_ = randn(2, W, 1, 256, dtype=dt), randn(2, W, 1, 256, dtype=dt)
        pages = paged_pool(torch, gen, pk_, pv_, pcp, pq, ps)
        qp = randn(2, 10, 256, dtype=dt)
        for kw in ({}, dict(window=16)):
            got = kops.paged_decode_attention(qp, *pages, pq, **kw)
            check_close(torch, f"paged_decode_attention hd 256 {dt} {kw}", got,
                        paged_plain(qp, *pages, pq, **kw), tol, tol)
            require(torch.equal(got, kops.decode_attention(qp, pk_, pv_, pcp, pq, **kw)),
                    f"paged_decode_attention hd 256 {dt} {kw}: not bit-identical to "
                    f"decode_attention over the same cache")
    print("decode_attention f32 hd 256 (window, softcap, plain) within 1e-4; "
          "paged_decode_attention hd 256 (bf16, f32) matches plain and is "
          "bit-identical to decode_attention")

    # gating dispatch: qwen2-moe (60 experts, top-4, d 2048) and arctic
    # (128 experts, top-2, d 7168), T = 4 and 8 tokens, C = T
    for model, d, E, K in (("qwen2-moe-a2.7b", 2048, 60, 4), ("arctic-480b", 7168, 128, 2)):
        wr = randn(d, E, dtype=torch.float32, scale=d ** -0.5)
        for T in (4, 8):
            r, _ = dispatch_shape(T, wr=wr, K=K, model=model)
            rows["gating_dispatch"]["shapes"].append(r)

    # grouped matmul: the expert GEMMs of one micro-batch (M = C = 4)
    def big(shape, scale):
        return torch.randn(shape, device=dev, generator=gen,
                           dtype=torch.bfloat16).mul_(scale)

    for model, G, d, f in (("qwen2-moe-a2.7b", 60, 2048, 1408),
                           ("arctic-480b", 128, 7168, 4864)):
        xe, he = big((G, 4, d), 1.0), big((G, 4, f), 1.0)
        w_up, w_down = big((G, d, f), d ** -0.5), big((G, f, d), f ** -0.5)
        for label, a, b in (("up", xe, w_up), ("down", he, w_down)):
            r = gm_shape(f"{label} ({model})", a, b)
            r["model"] = model
            rows["grouped_matmul"]["shapes"].append(r)
        if model == "arctic-480b":
            # the benchmark's decode micro-batch: 81 of 128 experts live
            counts = [2] * 47 + [1] * 34 + [0] * 47
            perm = torch.randperm(G, generator=torch.Generator().manual_seed(128))
            r = gm_decode_shape(torch, f"decode up ({model})", w_up,
                                [counts[i] for i in perm.tolist()], flush)
            r["model"] = model
            rows["grouped_matmul"]["shapes"].append(r)
        del xe, he, w_up, w_down
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phases 2-4
# the kernels the contiguous serving paths launch; the ping-pong runtime
# runs all three, the monolithic decode step only decode attention
SERVING_KERNELS = ("decode_attention", "gating_dispatch", "grouped_matmul")
MOE_KERNELS = ("gating_dispatch", "grouped_matmul")


def build_engine(torch, cfg, params, spec, runtime, kv_layout="contiguous",
                 prefix_cache=True, use_m2n=False, rebalance=False, nodes=1,
                 transfer=None, microbatches=None, transport="inproc"):
    """An engine of the port for ``spec``, made by the launcher's
    ``engine_for``: its disaggregated runtime (disagg / pingpong) is
    solved for ``nodes`` expert nodes, with the m2n dispatch and
    rebalancing every PLACE["rebalance_every"] decode iterations when
    asked; ``transfer`` ("sync" / "async") puts prefill on the prefill
    worker; ``microbatches`` ("auto" or a count) overrides spec's."""
    from repro_torch.launch.serve import engine_for
    from repro_torch.serving.config import ServingConfig
    sc = ServingConfig(max_batch=spec["max_batch"], max_seq=spec["max_seq"],
                       runtime=runtime,
                       microbatches=microbatches or spec["microbatches"],
                       kv_layout=kv_layout, page_size=spec.get("page_size", 16),
                       prefix_cache=prefix_cache, verbose=False,
                       device=str(params["embed"].device), use_m2n=use_m2n,
                       expert_nodes=nodes, transport=transport,
                       prefill_devices=int(transfer is not None),
                       transfer=transfer or "async",
                       expert_rebalance_every=PLACE["rebalance_every"] * rebalance)
    return engine_for(sc, cfg, params)


def zipf_params(torch, cfg, params):
    """A copy of ``params`` (the same weight tensors) with PLACE's zipf
    router bias on every MoE layer."""
    from repro_torch.launch.serve import inject_router_bias, zipf_router_bias
    out = dict(params, layers=[dict(lp) for lp in params["layers"]])
    return inject_router_bias(out, cfg, zipf_router_bias(cfg.moe.n_experts,
                                                         PLACE["zipf"]))


def phase_placement_parity(torch, dev, cfg, params):
    """Phase 2's placement runs: static ping-pong, rebalanced ping-pong
    and m2n with rebalancing (f32, full width, TF32 off) on the same
    requests under the zipf router bias, each with the launch counts set
    to 0 just before and read just after.  Greedy tokens identical across
    the three, the rebalanced runs re-solved at least once, replicated a
    hot expert and priced below the static run's imbalance."""
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    pz = zipf_params(torch, cfg, params)
    prompts = prompts_for(PLACE_F32, cfg.vocab)
    toks, st = {}, {}
    for name, (m2n, rebal) in PLACE_RUNS.items():
        eng = build_engine(torch, cfg, pz, PLACE_F32, "pingpong", use_m2n=m2n,
                           rebalance=rebal, nodes=PLACE["expert_nodes"])
        reset_launch_counts()
        toks[name] = serve(torch, eng, prompts, PLACE_F32["max_new"])[0]
        counts = launch_counts()
        st[name] = eng.stats()
        require(len(toks[name]) == PLACE_F32["n_requests"],
                f"f32 {name}: requests unfinished")
        require(toks[name] == toks["static"],
                f"f32 placement: {name} tokens {toks[name]} != static "
                f"{toks['static']}")
        for k in ("decode_attention", "gating_dispatch", "grouped_matmul"):
            require(counts[k] > 0, f"f32 {name}: {k} was not launched")
        require((counts["gating_dispatch[tables]"] > 0) == rebal
                and (counts["gating_dispatch[owner]"] > 0) == m2n,
                f"f32 {name}: gating_dispatch branch launches {counts}")
        if rebal:
            require(st[name]["rebalances"] > 0, f"f32 {name}: never rebalanced")
            require(st[name]["replicated_experts"] >= 1,
                    f"f32 {name}: no expert replicated")
            require(st[name]["imbalance"] < st["static"]["imbalance"],
                    f"f32 {name}: imbalance {st[name]['imbalance']} not below "
                    f"static {st['static']['imbalance']}")
        print(f"phase 2 [{name}]: imbalance {st[name]['imbalance']:.4f}, "
              f"rebalances {st[name]['rebalances']} "
              f"({st[name]['placement_updates']} installed), replicated experts "
              f"{st[name]['replicated_experts']}, loads "
              f"{[round(v) for v in st[name]['expert_loads']]}; launches "
              + " ".join(f"{k}={v}" for k, v in counts.items() if v))
        del eng
        torch.cuda.empty_cache()
    print(f"phase 2 placement (f32, {cfg.n_layers} layers, {PLACE['expert_nodes']} "
          f"expert nodes, zipf({PLACE['zipf']}), rebalance every "
          f"{PLACE['rebalance_every']}): " + ", ".join(PLACE_RUNS)
          + f" give identical greedy tokens for {len(prompts)} requests")
    return toks["static"]


def serve(torch, eng, prompts, max_new):
    from repro_torch.serving.engine import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=max_new))
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    return {r.rid: list(r.generated) for r in eng.finished}, time.perf_counter() - t0


def prompts_for(spec, vocab, seed=0):
    """``n_requests`` prompts of ``prompt_len`` tokens; with
    ``shared_prefix_len`` they all open with the same tokens."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n_shared = spec.get("shared_prefix_len", 0)
    shared = rng.randint(2, vocab, size=n_shared).tolist()
    return [shared + rng.randint(2, vocab, size=spec["prompt_len"] - n_shared).tolist()
            for _ in range(spec["n_requests"])]


def check_prefix_counts(stats, spec, name):
    """Every request but the first hits the shared prefix's full pages."""
    px = stats["prefix_cache"]
    n, shared = spec["n_requests"], spec["shared_prefix_len"]
    want = (n - 1, 1, (n - 1) * (shared // spec["page_size"]) * spec["page_size"])
    got = (px["hits"], px["misses"], px["hit_tokens"])
    require(got == want, f"{name}: prefix cache hits/misses/hit_tokens {got}, "
            f"expected {want}")


def phase_f32_parity(torch, dev, base_cfg):
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(base_cfg, n_layers=F32["n_layers"])
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    runs = {"monolithic": ("monolithic", "contiguous"),
            "pingpong": ("pingpong", "contiguous"),
            "paged monolithic": ("monolithic", "paged"),
            "paged pingpong": ("pingpong", "paged")}
    prompts = prompts_for(F32, cfg.vocab)
    toks, launches = {}, {}
    for name, (rt, layout) in runs.items():
        eng = build_engine(torch, cfg, params, F32, rt, layout)
        reset_launch_counts()
        toks[name] = serve(torch, eng, prompts, F32["max_new"])[0]
        launches[name] = launch_counts()
        require(len(toks[name]) == F32["n_requests"], f"f32 {name}: requests unfinished")
        require(toks[name] == toks["monolithic"],
                f"f32: {name} tokens {toks[name]} != monolithic "
                f"{toks['monolithic']}")
        # decode attention runs on its kernel on every path; the MoE
        # kernels only in ping-pong (the monolithic MoE layer is plain)
        counts = launches[name]
        require(counts["decode_attention"] > 0,
                f"f32: decode_attention was not launched on the {name} path")
        for k in MOE_KERNELS:
            require((counts[k] > 0) == (rt == "pingpong"),
                    f"f32: {name} path launched {k} {counts[k]} times")
        if layout == "paged":
            check_prefix_counts(eng.stats(), F32, f"f32 {name}")
        del eng
    print(f"phase 2 (f32, {cfg.n_layers} layers, full width): "
          + ", ".join(runs) + f" give identical greedy tokens for {len(prompts)} "
          f"requests ({sum(map(len, toks['monolithic'].values()))} tokens each); "
          f"paged runs hit the shared {F32['shared_prefix_len']}-token prefix "
          f"{F32['n_requests'] - 1} times")
    for name, counts in launches.items():
        print(f"phase 2 launches [{name}]: "
              + " ".join(f"{k}={v}" for k, v in counts.items()))
    torch.cuda.empty_cache()
    phase_prefill_worker_parity(torch, cfg, params, prompts, toks["monolithic"])
    return phase_placement_parity(torch, dev, cfg, params)


def warm_prompt(prompt, spec):
    """A prompt that shares ``prompt``'s system prompt and nothing after
    it: served first, it publishes the shared pages to the radix tree, so
    every later request hits them (a burst on a cold tree all misses)."""
    n = spec["shared_prefix_len"]
    return list(prompt[:n]) + list(range(2, 2 + spec["prompt_len"] - n))


def kv_hop_bytes(cfg, params, slots: int) -> int:
    """Bytes of one KV hop of ``slots`` token slots: every layer's K and V
    (``n_kv_heads`` x head_dim in the weights' dtype) and its int32
    positions."""
    itemsize = params["embed"].element_size()
    return cfg.n_layers * slots * (2 * cfg.n_kv_heads * cfg.resolved_head_dim
                                   * itemsize + 4)


def check_kv_hops(label, st, spec, layout, transfer, prompts, cfg, params):
    """Require the ledger's "kv" hops of one run: none without the prefill
    worker, one per non-shared page (paged) or per request row
    (contiguous) with it, each of the bytes its shape gives.  Returns
    (the ledger's kv entry, expected hops, bytes per hop)."""
    from repro_torch.serving.pages import n_pages_for
    kv = st["transport"].get("kv", {"hops": 0, "bytes": 0})
    if transfer is None:
        want_hops, per_hop = 0, 0
    elif layout == "paged":
        ps = spec["page_size"]
        shared = spec["shared_prefix_len"] // ps
        want_hops = sum(n_pages_for(len(p), ps) - shared for p in prompts)
        per_hop = kv_hop_bytes(cfg, params, ps)
    else:
        want_hops, per_hop = len(prompts), kv_hop_bytes(cfg, params, spec["max_seq"])
    require(kv["hops"] == want_hops and kv["bytes"] == want_hops * per_hop,
            f"{label}: kv hops {kv}, expected {want_hops} x {per_hop} B")
    return kv, want_hops, per_hop


# phase 2's prefill-worker engines: (runtime, layout, transfer,
# microbatches; None for the spec's).  m = 3 splits the 8-row batch as
# 3 / 3 / 2, the shapes of phase 6's m = auto run
WORKER_RUNS = {"worker sync": ("monolithic", "contiguous", "sync", None),
               "worker async": ("monolithic", "contiguous", "async", None),
               "pingpong worker sync": ("pingpong", "contiguous", "sync", None),
               "pingpong worker async": ("pingpong", "contiguous", "async", None),
               "pingpong m=3 worker async": ("pingpong", "contiguous", "async", 3),
               "paged pingpong worker+prefix": ("pingpong", "paged", "async", None),
               "disagg": ("disagg", "contiguous", None, None)}


def phase_prefill_worker_parity(torch, cfg, params, prompts, want):
    """Phase 2's prefill-cluster and disagg engines (f32, TF32 off) on the
    same requests, each with the launch counts and the transport ledger
    set to 0 just before and read just after: greedy tokens identical to
    the inline monolithic run, one "kv" hop per request (contiguous) or
    per non-shared page (paged; the tree seeded by ``warm_prompt`` first),
    each hop of the bytes its shape gives."""
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import Request
    for name, (rt, layout, transfer, mb) in WORKER_RUNS.items():
        eng = build_engine(torch, cfg, params, F32, rt, layout, transfer=transfer,
                           microbatches=mb)
        if layout == "paged":
            eng.submit(Request(rid=-1, prompt=warm_prompt(prompts[0], F32),
                               max_new_tokens=2))
            eng.run_until_done()
            eng.finished.clear()
        eng.transport.reset_stats()
        reset_launch_counts()
        got = serve(torch, eng, prompts, F32["max_new"])[0]
        counts = launch_counts()
        st = eng.stats()
        require(got == want, f"f32 {name}: tokens {got} != monolithic {want}")
        require(counts["decode_attention"] > 0,
                f"f32 {name}: decode_attention was not launched")
        for k in MOE_KERNELS:
            require((counts[k] > 0) == (rt != "monolithic"),
                    f"f32 {name}: launched {k} {counts[k]} times")
        kv, _, per_hop = check_kv_hops(f"f32 {name}", st, F32, layout, transfer,
                                       prompts, cfg, params)
        if layout == "paged":
            require(st["prefix_cache"]["hits"] >= len(prompts),
                    f"f32 {name}: prefix cache {st['prefix_cache']}")
        if mb is not None:
            require(len(eng.mb_slices) == mb,
                    f"f32 {name}: served in {len(eng.mb_slices)} micro-batches")
        require(st["disagg_prefill"] == (transfer is not None)
                and st["phases"]["transfer_mode"] == (transfer or "async"),
                f"f32 {name}: stats {st['disagg_prefill']} {st['phases']}")
        print(f"phase 2 [{name}]: tokens identical to monolithic; kv hops "
              f"{kv['hops']} x {per_hop} B; prefill batches "
              f"{st['phases'].get('prefill_batches', '(inline)')}; launches "
              + " ".join(f"{k}={v}" for k, v in counts.items() if v))
        del eng
    torch.cuda.empty_cache()


class record_routing:
    """Within the block, record the top-k routing of each MoE layer: the
    monolithic path's ``moe.route`` calls into ``mono.calls`` and the
    ping-pong runtime's ``gating_dispatch`` launches (shard 0's under
    m2n), re-routed by ``moe.route`` on the same router input, into
    ``pp.calls``, each as (experts (T, k), probabilities (T, E)) while
    its ``active`` is set."""

    def __init__(self):
        from repro_torch.kernels import ops as kops
        from repro_torch.models import moe as moe_lib
        self.kops, self.moe = kops, moe_lib
        self.mono = types.SimpleNamespace(active=False, calls=[])
        self.pp = types.SimpleNamespace(active=False, calls=[])

    def __enter__(self):
        route, dispatch = self.route, self.dispatch = (self.moe.route,
                                                       self.kops.gating_dispatch)
        mono, pp = self.mono, self.pp

        def rec_route(x, w, k, bias=None):
            r = route(x, w, k, bias)
            if mono.active:
                mono.calls.append((r.experts, r.probs))
            return r

        def rec_dispatch(x, w, k, *args, **kw):
            # under m2n every shard routes the same tokens: record one
            if pp.active and kw.get("owner") in (None, 0):
                r = route(x, w, k, kw.get("bias"))
                pp.calls.append((r.experts, r.probs))
            return dispatch(x, w, k, *args, **kw)

        self.moe.route, self.kops.gating_dispatch = rec_route, rec_dispatch
        return mono, pp

    def __exit__(self, *exc):
        self.moe.route, self.kops.gating_dispatch = self.route, self.dispatch


def check_bf16_logits(torch, label, want, got, calls_want, calls_got, L,
                      deep=False):
    """Hold bf16 logits ``got`` against ``want`` of another path on the
    same input, routing compared first.  bf16 weights and activations
    round at different places in the two paths -> logits within 5% of
    their range, and finite.  Top-k routing is not continuous: a token
    whose k-th and (k+1)-th expert probabilities nearly tie may take
    another expert on one path after a rounding difference, and its
    logits then differ by more.  So each path's routing is recorded
    (``record_routing``: per layer, one call or one per micro-batch),
    every row routed alike in every layer is held to 5%, and a row
    routed otherwise must show that the two paths' router probabilities
    leave it at a near-tie (margin < 1e-2) in that layer; at most half
    the rows may route otherwise.  ``deep``: a model deep enough that
    bf16 rounding meets a near-tie on most rows somewhere (qwen2-moe's 24
    layers of top-4 over 60 experts, whose probabilities are all near
    1/60): a row is held to the near-tie at its first differing layer
    only (its later layers follow from that flip), with no cap on the
    rows.  Returns the summary line."""
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
    scale = float(want.float().abs().max())
    row_rel = ((got.float() - want.float()).abs().amax(-1) / scale).tolist()
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())

    def per_layer(calls):
        n = len(calls) // L
        return [(torch.cat([e for e, _ in calls[l * n:(l + 1) * n]]),
                 torch.cat([p for _, p in calls[l * n:(l + 1) * n]]))
                for l in range(L)]

    flips = {}
    layers = (zip(per_layer(calls_want), per_layer(calls_got)) if calls_want
              else ())                  # a dense model routes nothing
    for l, ((m_e, m_p), (p_e, p_p)) in enumerate(layers):
        same = (m_e.sort(-1).values == p_e.sort(-1).values).all(-1)
        K = m_e.shape[1]
        for row in (~same).nonzero().flatten().tolist():
            margin = min(float(pr[row, K - 1] - pr[row, K])
                         for pr in (m_p.sort(-1, descending=True).values,
                                    p_p.sort(-1, descending=True).values))
            if not (deep and row in flips):
                flips.setdefault(row, []).append((l, margin))
    for row, rel in enumerate(row_rel):
        if row in flips:
            require(all(m < 1e-2 for _, m in flips[row]),
                    f"{label}: row {row} routed differently away from a near-tie: "
                    f"{flips[row]}")
        else:
            require(rel < 5e-2, f"{label}: logits of row {row} differ by {rel:.3e} "
                    f"with the same routing")
    require(deep or len(flips) <= len(row_rel) // 2,
            f"{label}: {len(flips)} of {len(row_rel)} rows routed differently")
    same_rel = max([r for i, r in enumerate(row_rel) if i not in flips], default=0.0)
    return (f"logits max rel diff {max(row_rel):.3e} over all rows, {same_rel:.3e} "
            f"over the {len(row_rel) - len(flips)} rows routed alike in every "
            f"layer; argmax agreement {agree:.2f}; near-tie routing flips "
            + (", ".join(f"row {r} layer {l} margin {m:.2e} (rel {row_rel[r]:.3e})"
                         for r, fl in sorted(flips.items()) for l, m in fl)
               or "none"))


def check_step_vs_monolithic(torch, dev, cfg, params, inst, slices, label,
                             spec=MAIN, routing=None, deep=False):
    """In-situ check of a ping-pong runtime: one decode step of ``inst``
    over the micro-batch ``slices`` against the monolithic decode_step on
    copies of one prefilled cache of ``spec``'s batch (check_bf16_logits),
    so its kernels are held at the shapes those micro-batches give them.
    ``routing``: a list that receives the runtime's recorded routing (one
    (experts, probabilities) pair per layer and micro-batch).  Returns
    the summary line."""
    from repro_torch.models.transformer import decode_step, prefill
    toks = torch.randint(2, cfg.vocab, (spec["max_batch"], spec["prompt_len"]),
                         device=dev, generator=torch.Generator(dev).manual_seed(1))
    _, c_ref = prefill(params, cfg, toks, max_seq=spec["max_seq"])
    c_pp = [{k: v.clone() for k, v in e.items()} for e in c_ref]
    pos = torch.full((spec["max_batch"],), spec["prompt_len"], dtype=torch.int32,
                     device=dev)
    with record_routing() as (mono, pp):
        mono.active = True
        want, _ = decode_step(params, cfg, toks[:, -1], c_ref, pos)
        mono.active, pp.active = False, True
        got, _ = inst.decode_microbatched(toks[:, -1], c_pp, pos, slices)
    if routing is not None:
        routing.extend(pp.calls)
    return check_bf16_logits(torch, label, want, got, mono.calls, pp.calls,
                             cfg.n_layers, deep=deep)


def phase_bf16_serving(torch, dev, cfg, params):
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import Request
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"]]
                   + [v for lp in params["layers"] for v in lp.values()])
    eng = build_engine(torch, cfg, params, MAIN, "pingpong")
    inst = eng.runtime
    line = check_step_vs_monolithic(torch, dev, cfg, params, inst, eng.mb_slices,
                                    "bf16")
    print(f"phase 3 check: bf16 pingpong vs monolithic {line}")

    # warm-up request (allocator pools, cuBLAS handles), then the main path
    eng.submit(Request(rid=-1, prompt=list(range(2, 2 + MAIN["prompt_len"])),
                       max_new_tokens=2))
    eng.run_until_done()
    eng.finished.clear()
    pre = eng.stats()
    inst.reset_stage_times()
    prompts = prompts_for(MAIN, cfg.vocab, seed=1)
    reset_launch_counts()
    out, wall = serve(torch, eng, prompts, MAIN["max_new"])
    launches = launch_counts()
    st = eng.stats()
    require(len(out) == MAIN["n_requests"], "bf16: not every request finished")
    for rid, gen in out.items():
        require(len(gen) == MAIN["max_new"], f"bf16: request {rid} got {len(gen)}")
        require(all(0 <= t < cfg.vocab for t in gen), f"bf16: bad token in {rid}")
    for name in SERVING_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the main path")
    iters = st["decode_iters"] - pre["decode_iters"]
    tokens = sum(map(len, out.values()))
    stages = st["stages"]
    ph = {k: st["phases"][k] - pre["phases"][k]
          for k in ("prefill_s", "decode_s", "transfer_s")}
    # each request's first token comes from its prefill; the rest from
    # decode iterations, timed by the engine's decode phase
    dec_tokens = tokens - len(out)
    print(f"phase 3 (bf16, {cfg.n_layers} layers, full width, "
          f"{n_params * 2 / 1e9:.2f} GB of weights): {len(out)} requests, "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.2f} tok/s served "
          f"(prefill included); {dec_tokens} decode tokens in "
          f"{ph['decode_s']:.3f} s = {dec_tokens / ph['decode_s']:.2f} tok/s "
          f"decoding, {iters} decode iters")
    print(f"phase 3 host phases: prefill {ph['prefill_s'] * 1e3:.1f} ms, "
          f"decode {ph['decode_s'] * 1e3:.1f} ms "
          f"({ph['decode_s'] / max(1, iters) * 1e3:.2f} ms/iter), "
          f"kv insert {ph['transfer_s'] * 1e3:.1f} ms")
    print("phase 3 device stages: " + " ".join(
        f"{s}={stages[f'{s}_s'] * 1e3:.3f}ms/{stages[f'{s}_n']}"
        for s in ("attn", "expert", "combine"))
        + f" | t_a={stages['t_a'] * 1e6:.1f}us t_e={stages['t_e'] * 1e6:.1f}us")
    print("phase 3 launches: " + " ".join(
        f"{k}={launches[k]} ({launches[k] / max(1, iters):.1f}/decode iter)"
        for k in SERVING_KERNELS) + f" over {iters} iters; prefill runs plain torch")
    profile_decode(torch, eng, prompts_for(MAIN, cfg.vocab, seed=2))
    return launches, stages


def planner_line(torch, cfg, stages):
    """The planner's performance model (``core.planner``, paper §4.2) at
    phase 3's shape under its H800 row, the published row nearest an H100
    SXM (the same compute and HBM, cut NVLink), beside phase 3's measured
    t_a and t_e per micro-batch and layer.  Printed only."""
    from repro_torch.core import planner
    hw = planner.HARDWARE["H800"]
    B, m = MAIN["max_batch"], MAIN["microbatches"]
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    b_a, b_e = B / m, B * K / (m * E)
    s = MAIN["prompt_len"] + MAIN["max_new"] / 2       # mean context of a step
    t_a = planner.attn_time(cfg, b_a, s, hw, 1)
    t_e = planner.expert_time(cfg, b_e, hw, 1)
    print(f"planner (H800 row: {hw.tflops} TFLOP/s, {hw.hbm_gbps} GB/s) at phase "
          f"3's shape (b_a = {b_a:g} rows, context {s:g}, b_e = {b_e:g} rows per "
          f"expert, tp 1): attn_time {t_a * 1e6:.1f} us, expert_time "
          f"{t_e * 1e6:.1f} us per expert = {E * t_e * 1e6:.1f} us for the {E} "
          f"experts one card runs; measured t_a {stages['t_a'] * 1e6:.1f} us, "
          f"t_e {stages['t_e'] * 1e6:.1f} us")


def phase_paged_serving(torch, dev, cfg, params):
    """Phase 4: the paged KV path at full width in bf16.  Returns the
    kernels-line rows of paged_decode_attention and gating_topk."""
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import Request
    prompts = prompts_for(PAGED, cfg.vocab, seed=3)
    runs = {"contiguous": ("contiguous", False),
            "paged": ("paged", False),
            "paged+prefix": ("paged", True)}
    toks, res, live = {}, {}, None
    for name, (layout, prefix) in runs.items():
        eng = build_engine(torch, cfg, params, PAGED, "pingpong", layout, prefix)
        # warm-up request, its own prompt: allocator pools, cuBLAS handles
        eng.submit(Request(rid=-1, prompt=list(range(2, 2 + PAGED["prompt_len"])),
                           max_new_tokens=2))
        eng.run_until_done()
        eng.finished.clear()
        pre = eng.stats()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=PAGED["max_new"]))
        reset_launch_counts()
        paused, step_s = 0.0, []
        t0 = time.perf_counter()
        while eng.outstanding:
            d0, n0 = eng.t_decode, eng.n_decode_iters
            eng.step()
            if eng.n_decode_iters > n0:
                step_s.append(eng.t_decode - d0)
            if (prefix and live is None
                    and eng.n_decode_iters - pre["decode_iters"] == LIVE_ITER):
                torch.cuda.synchronize()
                tp = time.perf_counter()
                live = launch_on_live_state(torch, dev, cfg, params, eng)
                torch.cuda.synchronize()
                paused += time.perf_counter() - tp
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - paused
        launches = launch_counts()
        st = eng.stats()
        toks[name] = {r.rid: list(r.generated) for r in eng.finished}
        require(len(toks[name]) == PAGED["n_requests"], f"paged {name}: unfinished")
        for k in SERVING_KERNELS:
            require(launches[k] > 0, f"paged {name}: {k} was not launched")
        ph = {k: st["phases"][k] - pre["phases"][k]
              for k in ("prefill_s", "decode_s", "transfer_s")}
        iters = st["decode_iters"] - pre["decode_iters"]
        dec_tokens = sum(map(len, toks[name].values())) - len(toks[name])
        res[name] = dict(ph, iters=iters, rate=dec_tokens / ph["decode_s"],
                         wall=wall, launches=launches,
                         median_iter=statistics.median(step_s))
        if name == "paged":
            # the paged step's gather and write-back, against phase 3's
            # contiguous profile
            profile_decode(torch, eng, prompts_for(PAGED, cfg.vocab, seed=5),
                           label="phase 4 profile [paged]")
        if layout == "paged":
            pool = eng.page_pool
            held = len(eng.prefix) if prefix else 0
            require(pool.used == held and pool.reserved == 0,
                    f"paged {name}: {pool.used} pages used, {pool.reserved} "
                    f"reserved after the run; the tree holds {held}")
            if prefix:
                px = {k: st["prefix_cache"][k] - pre["prefix_cache"][k]
                      for k in ("hits", "misses", "hit_tokens")}
                check_prefix_counts({"prefix_cache": px}, PAGED, f"paged {name}")
                res[name]["prefix"] = px
            res[name]["pages"] = st["kv_pages"]
        del eng
        torch.cuda.empty_cache()
    require(toks["paged"] == toks["contiguous"],
            "bf16: paged tokens differ from contiguous (the gather is a pure copy)")
    same = sum(a == b for a, b in zip(toks["paged+prefix"].values(),
                                      toks["contiguous"].values()))
    base = res["contiguous"]
    for name, r in res.items():
        extra = ""
        if "pages" in r:
            kp = r["pages"]
            extra = (f"; pool {kp['n_pages']} pages of {kp['page_size']}, "
                     f"high-water {kp['high_water']}, {kp['forks']} forks")
        if "prefix" in r:
            px = r["prefix"]
            extra += (f", prefix {px['hits']} hits / {px['misses']} misses "
                      f"({px['hit_tokens']} tokens reused)")
        print(f"phase 4 [{name}] ({params['embed'].dtype}, {cfg.n_layers} layers, "
              f"pingpong m = {PAGED['microbatches']}, batch {PAGED['max_batch']}): "
              f"{r['rate']:.2f} tok/s decoding, "
              f"{r['decode_s'] / max(1, r['iters']) * 1e3:.2f} ms/iter (median "
              f"{r['median_iter'] * 1e3:.2f}) over {r['iters']} iters; prefill "
              f"{r['prefill_s'] * 1e3:.1f} ms "
              f"({r['prefill_s'] / base['prefill_s']:.2f}x contiguous), kv write "
              f"{r['transfer_s'] * 1e3:.1f} ms (host phase times); serve wall "
              f"{r['wall']:.3f} s, of it outside decode "
              f"{(r['wall'] - r['decode_s']) * 1e3:.1f} ms "
              f"({(r['wall'] - r['decode_s']) / (base['wall'] - base['decode_s']):.2f}x "
              f"contiguous){extra}")
    print(f"phase 4: paged == contiguous greedy tokens for all "
          f"{PAGED['n_requests']} requests; paged+prefix equals contiguous for "
          f"{same} of them (bf16 suffix prefill rounds differently)")
    lv = res["paged+prefix"]["launches"]
    print("phase 4 launches [paged+prefix]: "
          + " ".join(f"{k}={v}" for k, v in lv.items()))
    require(lv["paged_decode_attention"] == cfg.n_layers and lv["gating_topk"] == 1,
            f"phase 4: live-state launches {lv}")
    return check_live_state(torch, cfg, live, lv)


def phase_placement_serving(torch, dev, cfg, params):
    """Phase 5: phase 3's bf16 model, width, batch and micro-batches under
    the zipf router bias over 4 expert nodes, served by the rebalanced
    ping-pong path, by static m2n and by m2n with rebalancing.  Each run
    is driven with
    the launch counts set to 0 just before and read just after, and
    reports its decode rate, ms per iteration, t_a and t_e, transport
    bytes per kind, and a profiled window whose gating_dispatch launches
    are counted (4 per micro-batch and layer under m2n) and timed.  Then
    one decode step of its runtime, placement installed, is held against
    a static ping-pong runtime on the same cache (check_bf16_logits).
    Returns the kernels-line launches of the two gating_dispatch
    variants."""
    from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import format_transport
    from repro_torch.models.transformer import prefill
    from repro_torch.serving.engine import Request
    pz = zipf_params(torch, cfg, params)
    L, B = cfg.n_layers, MAIN["max_batch"]
    toks = torch.randint(2, cfg.vocab, (B, MAIN["prompt_len"]), device=dev,
                         generator=torch.Generator(dev).manual_seed(6))
    _, c0 = prefill(pz, cfg, toks, max_seq=MAIN["max_seq"])
    pos = torch.full((B,), MAIN["prompt_len"], dtype=torch.int32, device=dev)

    def step(inst, slices):
        cache = [{k: v.clone() for k, v in e.items()} for e in c0]
        with record_routing() as (_, pp):
            pp.active = True
            logits, _ = inst.decode_microbatched(toks[:, -1], cache, pos, slices)
        return logits, pp.calls

    static = DisaggregatedInstance(cfg, pz, DisaggPlan(MAIN["microbatches"]))
    prompts = prompts_for(MAIN, cfg.vocab, seed=1)
    card = card_line()
    res = {}
    for name, (m2n, rebal) in TIMED_RUNS.items():
        eng = build_engine(torch, cfg, pz, MAIN, "pingpong", use_m2n=m2n,
                           rebalance=rebal, nodes=PLACE["expert_nodes"])
        inst = eng.runtime
        eng.submit(Request(rid=-1, prompt=list(range(2, 2 + MAIN["prompt_len"])),
                           max_new_tokens=2))
        eng.run_until_done()
        eng.finished.clear()
        pre = eng.stats()
        inst.reset_stage_times()
        eng.transport.reset_stats()
        reset_launch_counts()
        out, wall = serve(torch, eng, prompts, MAIN["max_new"])
        launches = launch_counts()
        st = eng.stats()
        require(len(out) == MAIN["n_requests"]
                and all(len(g) == MAIN["max_new"] for g in out.values())
                and all(0 <= t < cfg.vocab for g in out.values() for t in g),
                f"phase 5 {name}: requests unfinished or bad tokens")
        for k in SERVING_KERNELS:
            require(launches[k] > 0, f"phase 5 {name}: {k} was not launched")
        require((launches["gating_dispatch[tables]"] > 0) == rebal
                and (launches["gating_dispatch[owner]"] > 0) == m2n,
                f"phase 5 {name}: gating_dispatch branch launches {launches}")
        rebalances = st["rebalances"] - pre["rebalances"]
        require(not rebal or (rebalances > 0 and st["replicated_experts"] >= 1),
                f"phase 5 {name}: {rebalances} rebalances, "
                f"{st['replicated_experts']} replicated experts")
        iters = st["decode_iters"] - pre["decode_iters"]
        dec_s = st["phases"]["decode_s"] - pre["phases"]["decode_s"]
        dec_tokens = sum(map(len, out.values())) - len(out)
        stages = st["stages"]
        print(f"phase 5 [{name}] (bf16, {L} layers, pingpong m = "
              f"{MAIN['microbatches']}, batch {B}, {PLACE['expert_nodes']} expert "
              f"nodes{f' x {inst.placement_slots} slots' if rebal else ''}) on "
              f"{card}: {dec_tokens} decode "
              f"tokens in {dec_s:.3f} s = {dec_tokens / dec_s:.2f} tok/s decoding, "
              f"{dec_s / max(1, iters) * 1e3:.2f} ms/iter over {iters} iters; "
              f"t_a={stages['t_a'] * 1e6:.1f}us t_e={stages['t_e'] * 1e6:.1f}us; "
              f"{rebalances} rebalances ({st['placement_updates'] - pre['placement_updates']}"
              f" installed, {(st['rebalance_s'] - pre['rebalance_s']) * 1e3:.1f} ms), "
              f"imbalance {st['imbalance']:.4f}, replicated experts "
              f"{st['replicated_experts']}")
        print(f"phase 5 [{name}] {format_transport(st['transport'])}")
        print(f"phase 5 [{name}] launches: "
              + " ".join(f"{k}={v}" for k, v in launches.items() if v))
        prof = profile_decode(torch, eng, prompts_for(MAIN, cfg.vocab, seed=2),
                              label=f"phase 5 profile [{name}]")
        per_call = PLACE["expert_nodes"] if m2n else 1
        want_calls = 3 * L * len(eng.mb_slices) * per_call
        require(prof["calls"] == want_calls,
                f"phase 5 {name}: {prof['calls']} gating_dispatch calls in the "
                f"window, expected {want_calls}")
        print(f"phase 5 [{name}] profile: gating_dispatch {prof['kernels']} launches "
              f"({per_call} per micro-batch and layer) in 3 iters, "
              f"{prof['us'] / prof['kernels']:.2f} us each, "
              f"{prof['us'] / 1e3:.3f} ms in all; device busy {prof['busy_ms']:.2f} "
              f"ms of {prof['window_ms']:.2f} ms")
        want, calls_want = step(static, eng.mb_slices)
        got, calls_got = step(inst, eng.mb_slices)
        line = check_bf16_logits(torch, f"phase 5 {name}", want, got, calls_want,
                                 calls_got, L)
        print(f"phase 5 check [{name}] vs static pingpong: {line}")
        res[name] = launches
        del eng, inst
        torch.cuda.empty_cache()
    return {"gating_dispatch[tables]": res["rebalanced"]["gating_dispatch[tables]"],
            "gating_dispatch[owner]": res["m2n+rebalanced"]["gating_dispatch[owner]"]}


# phase 6's serving runs: (runtime, layout, transfer, microbatches,
# transport, spec).  The m = auto run prices its hops with the RDMA model,
# so eq. 3 picks an m other than the other runs' 2; the run after it
# differs from it only in m
CLUSTER_RUNS = {
    "pingpong m=auto simrdma + worker async": ("pingpong", "contiguous", "async",
                                               "auto", "simrdma", MAIN),
    "pingpong m=2 simrdma + worker async": ("pingpong", "contiguous", "async",
                                            2, "simrdma", MAIN),
    "paged pingpong + worker + prefix": ("pingpong", "paged", "async", None,
                                         "inproc", PAGED),
    "disagg": ("disagg", "contiguous", None, None, "inproc", MAIN)}


def phase_prefill_cluster(torch, dev, cfg, params):
    """Phase 6: phase 3's bf16 model, width, batch and requests.  First the
    micro-batch choice of paper eq. 3 from one profiled decode iteration
    under each transport (t_a, t_e, t_c and the m chosen), then the
    CLUSTER_RUNS, each after a warm-up request (for the paged run one
    that seeds the radix tree) with the launch counts and the ledger set
    to 0 just before and read just after: decode rate, ms per iteration,
    KV transfer time and hops, prefill batches, every kernel of the path
    launched, and each kv hop of the bytes its shape gives."""
    from repro_torch.core import pingpong
    from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
    from repro_torch.core.transport import make_transport
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import Request
    B, L = MAIN["max_batch"], cfg.n_layers
    card = card_line()
    chosen = {}
    for backend in ("inproc", "simrdma"):
        inst = DisaggregatedInstance(cfg, params, DisaggPlan(2),
                                     transport=make_transport(backend))
        rep = inst.measure_stage_times(B)
        m = pingpong.choose_microbatches(rep["t_a"], rep["t_e"], rep["t_c"],
                                         max_m=B)
        chosen[backend] = m
        require(rep["attn_n"] == rep["m2n_n"] == rep["expert_n"] == rep["n2m_n"]
                == 2 * L, f"phase 6 {backend}: stage counts {rep}")
        require((rep["t_c"] == 0.0) == (backend == "inproc"),
                f"phase 6 {backend}: t_c {rep['t_c']}")
        print(f"phase 6 eq. 3 [{backend}] (bf16, {L} layers, batch {B}, one "
              f"profiled decode iteration at m = 2) on {card}: "
              f"t_a={rep['t_a'] * 1e6:.1f}us t_e={rep['t_e'] * 1e6:.1f}us "
              f"t_c={rep['t_c'] * 1e6:.3f}us -> m = {m} "
              f"(2 (1 + t_c / t_f) = "
              f"{2 * (1 + rep['t_c'] / max(rep['t_a'], rep['t_e'])):.4f})")
        del inst
    require(chosen["inproc"] == 2, f"phase 6: inproc chose m = {chosen['inproc']}")
    for name, (rt, layout, transfer, mb, backend, spec) in CLUSTER_RUNS.items():
        eng = build_engine(torch, cfg, params, spec, rt, layout, transfer=transfer,
                           microbatches=mb, transport=backend)
        prompts = prompts_for(spec, cfg.vocab, seed=1)
        warm = (warm_prompt(prompts[0], spec) if layout == "paged"
                else list(range(2, 2 + spec["prompt_len"])))
        eng.submit(Request(rid=-1, prompt=warm, max_new_tokens=2))
        eng.run_until_done()
        eng.finished.clear()
        pre = eng.stats()
        eng.transport.reset_stats()
        if eng.mode == "pingpong":
            eng.runtime.reset_stage_times()
        reset_launch_counts()
        out, wall = serve(torch, eng, prompts, spec["max_new"])
        launches = launch_counts()
        st = eng.stats()
        require(len(out) == spec["n_requests"]
                and all(len(g) == spec["max_new"] for g in out.values())
                and all(0 <= t < cfg.vocab for g in out.values() for t in g),
                f"phase 6 {name}: requests unfinished or bad tokens")
        for k in SERVING_KERNELS:
            require(launches[k] > 0, f"phase 6 {name}: {k} was not launched")
        kv, want_hops, per_hop = check_kv_hops(f"phase 6 {name}", st, spec, layout,
                                               transfer, prompts, cfg, params)
        ph = {k: st["phases"][k] - pre["phases"][k]
              for k in ("decode_s", "decode_n", "transfer_s", "transfer_n")}
        batches = (st["phases"]["prefill_batches"] - pre["phases"]["prefill_batches"]
                   if transfer else "(inline)")
        dec_tokens = sum(map(len, out.values())) - len(out)
        m = (len(eng.mb_slices) if eng.mb_slices is not None
             else eng.runtime.plan.n_microbatches)
        require(mb != "auto" or m == chosen[backend],
                f"phase 6 {name}: served at m = {m}, eq. 3 chose {chosen[backend]}")
        print(f"phase 6 [{name}] (bf16, {L} layers, {rt} m = {m}, batch {B}, "
              f"transfer {transfer or 'inline'}) on {card}: {dec_tokens} decode "
              f"tokens in {ph['decode_s']:.3f} s = {dec_tokens / ph['decode_s']:.2f} "
              f"tok/s decoding, {ph['decode_s'] / max(1, ph['decode_n']) * 1e3:.2f} "
              f"ms/iter over {ph['decode_n']} iters; serve wall {wall:.3f} s")
        print(f"phase 6 [{name}] transfer_s={ph['transfer_s'] * 1e3:.2f}ms "
              f"transfer_n={ph['transfer_n']} prefill_batches={batches}; kv hops "
              f"{kv['hops']}, {kv['bytes']} B = {want_hops} x {per_hop} B expected"
              + (f"; prefix {st['prefix_cache']['hits']} hits" if layout == "paged"
                 else ""))
        if "stages" in st:
            sr = st["stages"]
            print(f"phase 6 [{name}] device stages per micro-batch and layer: "
                  f"t_a={sr['t_a'] * 1e6:.1f}us t_e={sr['t_e'] * 1e6:.1f}us "
                  f"t_c={sr['t_c'] * 1e6:.3f}us over {sr['attn_n']} micro-batch "
                  f"layers")
        print(f"phase 6 [{name}] launches: " + " ".join(
            f"{k}={launches[k]}" for k in SERVING_KERNELS))
        if eng.mode == "pingpong" and m != MAIN["microbatches"]:
            # micro-batches of other row counts than phases 1 and 3 hold
            line = check_step_vs_monolithic(
                torch, dev, cfg, params, eng.runtime, eng.mb_slices,
                f"phase 6 {name}")
            print(f"phase 6 check [{name}] m = {m} "
                  f"({[s.stop - s.start for s in eng.mb_slices]} rows) vs "
                  f"monolithic: {line}")
        del eng
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 7
# every config of the registry at its published widths: (bf16 depth, None
# = whole; ping-pong served too).  The f32 check runs one period of the
# block pattern (arctic-480b: one layer, ~56 GB)
REGISTRY_RUNS = {
    "mamba2-1.3b": (None, False),
    "recurrentgemma-2b": (None, False),
    "whisper-large-v3": (None, False),
    "qwen2-moe-a2.7b": (None, True),
    "arctic-480b": (2, True),
    "gemma2-27b": (4, True),
    "llama-3.2-vision-90b": (5, False),
    "granite-3-8b": (4, False),
    "minitron-4b": (4, False),
    "minitron-8b": (4, False),
}
REG = dict(max_batch=8, microbatches=2, max_seq=64, n_requests=8, prompt_len=16,
           max_new=32)
REG_F32 = dict(REG, max_batch=2, n_requests=2, max_new=4)
SELF_ATTN = ("attn", "local", "selfcross")


def cut(cfg, n_layers):
    """``cfg`` cut to ``n_layers`` of its block pattern (no remainder), or
    whole with None."""
    if n_layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=n_layers, remainder_pattern=())


def rank_block_place(cfg, mesh):
    """``init_params``' ``place`` that keeps this rank's block of each leaf
    under ``sharding.param_specs`` (the JAX "ep" rules) as soon as the leaf
    is drawn: ``sharding.shard_tree`` of the whole draw, leaf by leaf, so
    a rank never holds the whole tree (the values are the seed's)."""
    from repro_torch.launch import sharding
    from repro_torch.models.transformer import init_params
    specs = dict(sharding.named_specs(sharding.param_specs(
        cfg, init_params(cfg, device="meta"), mesh)))
    return lambda path, t: sharding.local_shard(t, specs[path], mesh)


def registry_params(torch, cfg, dtype, dev, place=None):
    """Random weights from seed 0 (``place``: ``init_params``'); the
    llama-3.2-vision cross layers' tanh gates (0 at init, which makes each
    cross layer the identity) opened to 0.5 so the cross path does work."""
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, seed=0, dtype=dtype, device=dev, place=place)
    for lp in params["layers"]:
        for g in ("gate_attn", "gate_ffn"):
            if g in lp:
                lp[g].fill_(0.5)
    return params


def registry_f32(torch, dev, name, cfg, pingpong):
    """f32 (TF32 off), full width, one period: prefill 2 requests, 4
    greedy decode steps through the cache (the kernels), and the port's
    full-sequence pass (``forward_hidden``, plain attention, no cache)
    over the same tokens; every step's logits within 5e-4 of the logits'
    range of the full pass's.  With ping-pong, the ping-pong engine's
    tokens equal the monolithic engine's.  Returns the peak memory."""
    from repro_torch.models.stubs import extra_inputs
    from repro_torch.models.transformer import (decode_step, forward_hidden,
                                                lm_head, prefill)
    torch.cuda.reset_peak_memory_stats()
    params = registry_params(torch, cfg, torch.float32, dev)
    B, T, n = REG_F32["n_requests"], REG_F32["prompt_len"], REG_F32["max_new"]
    toks = torch.randint(2, cfg.vocab, (B, T), device=dev,
                         generator=torch.Generator(dev).manual_seed(5))
    ex = extra_inputs(cfg, B, device=dev)
    logits, cache = prefill(params, cfg, toks, max_seq=REG_F32["max_seq"], **ex)
    steps, seq = [logits], toks
    pos = torch.full((B,), T, dtype=torch.int32, device=dev)
    for _ in range(n):
        nxt = steps[-1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = decode_step(params, cfg, nxt, cache, pos)
        steps.append(logits)
        pos = pos + 1
    hidden, _ = forward_hidden(params, cfg, seq, remat="none", capacity_mode="full",
                               **ex)
    full = lm_head(params, cfg, hidden)
    rng = float(full.max() - full.min())
    err = max(float((full[:, T - 1 + i] - st).abs().max()) for i, st in enumerate(steps))
    require(bool(torch.isfinite(full).all()), f"phase 7 {name} f32: non-finite logits")
    require(err <= 5e-4 * rng, f"phase 7 {name} f32: decode logits differ from the "
            f"full-sequence pass by {err:.3e} (range {rng:.3e})")
    line = (f"phase 7 [{name}] f32 ({cfg.n_layers} layers {cfg.layer_kinds}, full "
            f"width): prefill + {n} decode steps vs the full-sequence pass: max "
            f"|diff| {err:.3e} = {err / rng:.2e} of the logits' range")
    del cache, full
    if pingpong:
        prompts = prompts_for(REG_F32, cfg.vocab, seed=6)
        out = {}
        for rt in ("monolithic", "pingpong"):
            eng = build_engine(torch, cfg, params, REG_F32, rt)
            out[rt] = serve(torch, eng, prompts, n)[0]
            del eng
        require(out["pingpong"] == out["monolithic"],
                f"phase 7 {name} f32: ping-pong tokens {out['pingpong']} != "
                f"monolithic {out['monolithic']}")
        line += "; ping-pong m = 2 tokens equal monolithic"
    peak = torch.cuda.max_memory_allocated()
    print(line + f"; peak {peak / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()
    return peak


def idle_expert_line(cfg, routing):
    """Bytes the expert kernel reads per call (every expert's weights:
    the capacity buffers cover all E) against the bytes of the experts
    that hold a token, from one decode step's recorded routing."""
    E, f, d = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    per_expert = 3 * d * f * 2
    held = [len(set(e.flatten().tolist())) for e, _ in routing]
    mean = sum(held) / len(held)
    return (f"{E * per_expert / 1e9:.3f} GB of expert weights read per micro-batch "
            f"and layer; experts holding a token {min(held)}-{max(held)} (mean "
            f"{mean:.2f}) of {E} over {len(held)} calls = {mean * per_expert / 1e9:.3f} "
            f"GB ({mean / E:.3f} of the bytes read)")


def registry_serve(torch, dev, name, cfg, rt, params, prompts):
    """Serve REG's 8 requests on ``rt`` after a warm-up request, with the
    launch counts set to 0 just before and read just after; then trace
    three decode iterations for the busy share.  Returns the launches."""
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import Request
    eng = build_engine(torch, cfg, params, REG, rt)
    eng.submit(Request(rid=-1, prompt=list(range(2, 2 + REG["prompt_len"])),
                       max_new_tokens=2))
    eng.run_until_done()
    eng.finished.clear()
    pre = eng.stats()
    reset_launch_counts()
    out, wall = serve(torch, eng, prompts, REG["max_new"])
    launches = launch_counts()
    st = eng.stats()
    require(len(out) == REG["n_requests"]
            and all(len(g) == REG["max_new"] for g in out.values())
            and all(0 <= t < cfg.vocab for g in out.values() for t in g),
            f"phase 7 {name} {rt}: requests unfinished or bad tokens")
    if any(k in SELF_ATTN for k in cfg.layer_kinds):
        require(launches["decode_attention"] > 0,
                f"phase 7 {name} {rt}: decode_attention was not launched")
    if rt == "pingpong" and cfg.moe is not None:
        for k in MOE_KERNELS:
            require(launches[k] > 0, f"phase 7 {name} {rt}: {k} was not launched")
    dec_s = st["phases"]["decode_s"] - pre["phases"]["decode_s"]
    iters = st["decode_iters"] - pre["decode_iters"]
    dec_tokens = sum(map(len, out.values())) - len(out)
    tr = trace_decode(torch, eng, prompts_for(REG, cfg.vocab, seed=8))
    print(f"phase 7 [{name}] bf16 {rt} ({cfg.n_layers} layers, batch "
          f"{REG['max_batch']}) on {card_line()}: {dec_tokens} decode tokens in "
          f"{dec_s:.3f} s = {dec_tokens / dec_s:.2f} tok/s, {dec_s / iters * 1e3:.2f} "
          f"ms/iter over {iters} iters; serve wall {wall:.3f} s; device busy "
          f"{tr.busy_us / tr.wall_us:.3f} of a 3-iteration window "
          f"({tr.wall_us / 3e3:.2f} ms/iter traced, {tr.busy_us / 3e3:.2f} ms busy, "
          f"{tr.n_ops / 3:.0f} device ops per iter); launches "
          + " ".join(f"{k}={launches[k]}" for k in SERVING_KERNELS))
    if "stages" in st:
        sr = st["stages"]
        print(f"phase 7 [{name}] {rt} device stages: t_a={sr['t_a'] * 1e6:.1f}us "
              f"t_e={sr['t_e'] * 1e6:.1f}us per micro-batch and layer")
    del eng
    return launches


def phase_registry(torch, dev):
    """Phase 7: every config of the registry but the paper's, at its
    published widths (REGISTRY_RUNS).  f32 first (registry_f32), then bf16
    at the table's depth: monolithic, and ping-pong m = 2 for the
    attention families the runtime serves, its one decode step held
    against the monolithic step routing-first (as phase 3).  Each model
    is freed before the next is built; the peak memory of each is
    printed.  Returns each model's launches on its bf16 path (ping-pong
    where served, else monolithic)."""
    from repro_torch.config import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path_launches = {}
    for name, (depth, pingpong) in REGISTRY_RUNS.items():
        t0 = time.perf_counter()
        full = get_config(name)
        peak32 = registry_f32(torch, dev, name, cut(full, len(full.block_pattern)),
                              pingpong)
        cfg = cut(full, depth)
        torch.cuda.reset_peak_memory_stats()
        params = registry_params(torch, cfg, torch.bfloat16, dev)
        n_bytes = sum(t.numel() * t.element_size() for lp in
                      [params] + params["layers"] + params.get("encoder", {}).get(
                          "layers", [])
                      for t in lp.values() if isinstance(t, torch.Tensor))
        prompts = prompts_for(REG, cfg.vocab, seed=7)
        launches = registry_serve(torch, dev, name, cfg, "monolithic", params, prompts)
        if pingpong:
            # one period of layers by phase 3's rule, then the served depth
            # (first flips only past phase 3's 4 layers)
            P = len(cfg.block_pattern)
            one = cut(cfg, P)
            eng = build_engine(torch, one, dict(params, layers=params["layers"][:P]),
                               REG, "pingpong")
            line = check_step_vs_monolithic(
                torch, dev, one, dict(params, layers=params["layers"][:P]),
                eng.runtime, eng.mb_slices, f"phase 7 {name} ({P} layers)", spec=REG)
            print(f"phase 7 check [{name}] bf16 pingpong vs monolithic, {P} "
                  f"layer{'s' if P > 1 else ''}: {line}")
            routing = []
            eng = build_engine(torch, cfg, params, REG, "pingpong")
            deep = cfg.n_layers > MAIN["n_layers"]
            line = check_step_vs_monolithic(torch, dev, cfg, params, eng.runtime,
                                            eng.mb_slices, f"phase 7 {name}",
                                            spec=REG, routing=routing, deep=deep)
            print(f"phase 7 check [{name}] bf16 pingpong vs monolithic, "
                  f"{cfg.n_layers} layers{' (first flips)' if deep else ''}: {line}")
            if cfg.moe is not None:
                print(f"phase 7 [{name}] idle experts: "
                      + idle_expert_line(cfg, routing))
            del eng
            launches = registry_serve(torch, dev, name, cfg, "pingpong", params,
                                      prompts)
        path_launches[name] = launches
        peak = torch.cuda.max_memory_allocated()
        require(peak < 80e9, f"phase 7 {name}: peak {peak / 1e9:.2f} GB")
        print(f"phase 7 [{name}]: {cfg.n_layers} of {full.n_layers} layers"
              + (f" + {cfg.encoder.n_layers} encoder layers" if cfg.encoder else "")
              + f", {n_bytes / 1e9:.2f} GB of bf16 weights; peak memory "
              f"{peak / 1e9:.2f} GB (bf16), {peak32 / 1e9:.2f} GB (f32 check); "
              f"{time.perf_counter() - t0:.1f} s")
        del params
        torch.cuda.empty_cache()
    return path_launches


def launch_on_live_state(torch, dev, cfg, params, eng):
    """At a decode iteration of the paged engine: launch the paged kernel
    on every layer of its live pool through its block tables, with a
    seeded query of the serving shape at each row's position, and the
    gating_topk kernel on layer 0's router input for micro-batch 0 (the
    next iteration's normed activations).  Keeps copies of the inputs
    for the checks that follow the run."""
    import numpy as np
    from repro_torch.kernels import ops as kops
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import embed_tokens, self_attn_decode_sublayer
    pool = eng.page_pool
    bt_np = eng.block_table_array()
    pos_np = np.zeros((eng.max_batch,), np.int32)
    for req in eng.running.values():
        pos_np[req.slot] = req.position - 1
    require(len(eng.running) == eng.max_batch and bool((bt_np[:, 0] >= 0).all()),
            "phase 4: not every row serves a request at the live iteration")
    bt = torch.from_numpy(bt_np).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    gen = torch.Generator(dev).manual_seed(4)
    q = torch.randn(eng.max_batch, cfg.n_heads, cfg.resolved_head_dim, device=dev,
                    generator=gen).to(pool.store[0]["k"].dtype)
    outs = [kops.paged_decode_attention(q, e["k"], e["v"], e["pos"], bt, pos)
            for e in pool.store]
    mb = eng.mb_slices[0]
    p0 = params["layers"][0]
    scratch = pool.gather(bt_np)[0]
    toks = torch.tensor(eng._last_token, dtype=torch.int64, device=dev)[mb]
    x = embed_tokens(params, cfg, toks)
    x = x + self_attn_decode_sublayer(p0, cfg, x, pos[mb],
                                      {k: v[mb] for k, v in scratch.items()}, 0)
    h = rms_norm(x, p0["ln2"])
    topk = kops.gating_topk(h, p0["router"], cfg.moe.top_k)
    return dict(q=q, bt=bt, bt_np=bt_np, pos=pos, outs=outs, h=h,
                router=p0["router"], topk=topk,
                store=[{k: t.clone() for k, t in e.items()} for e in pool.store],
                dense=pool.gather(bt_np))


def check_live_state(torch, cfg, live, launches):
    """The live-state launches against their plain versions (and the
    paged kernel against decode_attention over the gathered view), then
    both kernels timed on those inputs.  Returns their kernels-line rows."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.gating_topk import gating_topk_plain
    from repro_torch.models.attention import paged_decode_attention as paged_plain
    q, bt, pos = live["q"], live["bt"], live["pos"]
    errs = []
    for l, (out, st, d) in enumerate(zip(live["outs"], live["store"], live["dense"])):
        want = paged_plain(q, st["k"], st["v"], st["pos"], bt, pos)
        dense = kops.decode_attention(q, d["k"], d["v"], d["pos"], pos)
        torch.cuda.synchronize()
        check_close(torch, f"live paged_decode_attention layer {l}", out, want,
                    2e-2, 2e-2)
        require(torch.equal(out, dense),
                f"live paged_decode_attention layer {l}: not bit-identical to "
                f"decode_attention over the gathered view (max |diff| "
                f"{max_err(torch, out, dense):.3e})")
        errs.append(max_err(torch, out, want))
    # the same L2 flush as phase 1: the decode step finds its inputs cold
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=q.device)
    st = live["store"][0]
    args = (q, st["k"], st["v"], st["pos"], bt, pos)
    P, ps, Hkv, hd = st["k"].shape
    mapped = bt >= 0
    slot_pos = torch.where(mapped[:, :, None], st["pos"][bt.long().clamp(min=0)], -1)
    valid = int(((slot_pos >= 0) & (slot_pos <= pos[:, None, None])).sum())
    nbytes = (2 * q.numel() * 2 + valid * Hkv * hd * 2 * 2 + bt.numel() * 4
              + int(mapped.sum()) * ps * 4 + pos.numel() * 4)
    paged_row = dict(
        err=max(errs), launches=launches["paged_decode_attention"],
        ms=time_ms(torch, lambda: kops.paged_decode_attention(*args), flush=flush),
        plain_ms=time_ms(torch, lambda: paged_plain(*args), flush=flush),
        library_ms=None,
        bound=bound_ms(nbytes, 4 * valid * cfg.n_heads * hd, "bfloat16"),
        replaces="src/repro/kernels/decode_attention.py:209")
    print(f"phase 4 live paged_decode_attention: q {tuple(q.shape)} over the pool "
          f"{tuple(st['k'].shape)} x {cfg.n_layers} layers, table "
          f"{tuple(bt.shape)} ({int(mapped.sum())} pages mapped, {valid} valid "
          f"slots), positions {pos.tolist()}: max |err| {max(errs):.3e} vs plain, "
          f"bit-identical to decode_attention over the gathered view on every "
          f"layer; {paged_row['ms']:.4f} ms, plain {paged_row['plain_ms']:.4f} ms")
    h, w, K = live["h"], live["router"], cfg.moe.top_k
    want = gating_topk_plain(h, w, K)
    check_topk(torch, "live gating_topk", live["topk"], want)
    T, d = h.shape
    E = w.shape[1]
    topk_row = dict(
        err=max_err(torch, live["topk"][0], want[0]), launches=launches["gating_topk"],
        ms=time_ms(torch, lambda: kops.gating_topk(h, w, K), flush=flush),
        plain_ms=time_ms(torch, lambda: gating_topk_plain(h, w, K), flush=flush),
        library_ms=None,
        bound=bound_ms(h.numel() * 2 + w.numel() * 4 + T * K * 8 + E * 4,
                       2 * T * d * E, "float32"),
        replaces="src/repro/kernels/gating_topk.py:89")
    print(f"phase 4 live gating_topk: layer 0 router input {tuple(h.shape)} "
          f"{h.dtype}, experts {live['topk'][1].tolist()} identical to moe.route, "
          f"counts {live['topk'][2].tolist()}; {topk_row['ms']:.4f} ms, plain "
          f"{topk_row['plain_ms']:.4f} ms")
    del flush
    print("library_ms is null for paged_decode_attention (no PyTorch call reads "
          "a block table; scaled_dot_product_attention needs the gathered view), "
          "gating_topk (top-k routing is three calls: matmul, softmax, topk) and "
          "gating_dispatch (no single PyTorch call routes and builds the "
          "capacity buffers)")
    return {"paged_decode_attention": paged_row, "gating_topk": topk_row}


# ----------------------------------------------------------------- phase 8
# the trainer: the JAX launcher's defaults (f32, lr 1e-3, warmup
# max(2, steps // 10), remat none) on mixtral-8x22b at its published
# widths, cut to one layer (params, grads and two f32 moments of one
# layer take 46.4 GB; two layers, 86 GB, do not fit the card)
TRAIN = dict(arch="mixtral-8x22b", n_layers=1, batch=8, seq=128, steps=10,
             lr=1e-3, seed=0)
TRAIN_RETRY_LR = 3e-4       # AdamWConfig's default, tried once if the loss
                            # does not fall at TRAIN["lr"] (below its first
                            # 3 steps' mean and its first step's)
TIMED_STEPS = slice(2, None)  # steps 3-10 make the median


class train_probe:
    """Within the block, wrap the pieces the train step calls by name
    (``training.loop.lm_loss`` and ``adamw_update``, ``models.moe.route``):
    record each call's routing (experts on the host), the gradients
    handed to the update (host copies, with ``keep_grads``), the update's
    metrics and, with ``timed``, a CUDA event where each step starts, one
    on each side of the update, and the device memory allocated after the
    forward."""

    def __init__(self, torch, keep_grads=False, timed=False):
        from repro_torch.models import moe as moe_lib
        from repro_torch.training import loop
        self.torch, self.loop, self.moe = torch, loop, moe_lib
        self.keep, self.timed = keep_grads, timed
        self.rec = types.SimpleNamespace(routing=[], grads=[], metrics=[],
                                         events=[], memory=[])

    def _event(self):
        if not self.timed:
            return None
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __enter__(self):
        torch, rec = self.torch, self.rec
        self.saved = lm_loss, update, route = (self.loop.lm_loss,
                                               self.loop.adamw_update, self.moe.route)

        def rec_loss(params, *a, **kw):
            start = self._event()
            out = lm_loss(params, *a, **kw)
            if self.timed:
                rec.memory.append(torch.cuda.memory_allocated())
            rec.events.append([start])
            return out

        def rec_update(cfg, params, grads, state, **kw):
            if self.keep:
                rec.grads.append([g.detach().cpu().clone() for g in grads])
            before = self._event()
            out = update(cfg, params, grads, state, **kw)
            rec.events[-1] += [before, self._event()]
            rec.metrics.append(out[2])
            return out

        def rec_route(*a, **kw):
            r = route(*a, **kw)
            rec.routing.append(r.experts.cpu())
            return r

        self.loop.lm_loss, self.loop.adamw_update, self.moe.route = (
            rec_loss, rec_update, rec_route)
        return rec

    def __exit__(self, *exc):
        self.loop.lm_loss, self.loop.adamw_update, self.moe.route = self.saved


def phase_train_parity(torch, dev):
    """Phase 8(a): one ``train_step`` on the card and the same step on the
    CPU, in f32 with TF32 off, from the same ``init_params`` draw (made on
    the CPU, copied to the card) and the same ``SyntheticLM`` batch, on
    reduced mixtral-8x22b and qwen2-moe-a2.7b (shared experts, top-4 of
    the full config cut to 2 of 4 experts).  In order: routing equal;
    loss and aux within 1e-5 relative; every gradient within 1e-4 of its
    leaf's max |g| (the card's embedding and token-gather backward add
    with atomics, in no fixed order); the card's update of the CPU's
    gradients within 1e-5 of the range of the CPU's updated params.

    The step's own updated params are printed beside, not held to 1e-5:
    at step 1 AdamW moves an element by lr * g / (|g| + eps), nearly
    +-lr whatever |g|, so an element whose gradient is a cancellation
    to ~1e-7 (its f32 noise ~1e-6 of the leaf's max) moves by a share of
    lr that the two devices' summation orders set apart (measured: a
    few elements in 10^5, 4e-4 of the embedding's range).  Holding the
    update on the same gradients checks the card's arithmetic; the
    gradient check holds what feeds it.  The step's own difference is
    still held loosely: at most 1e-4 of the elements past 1e-5 of their
    leaf's range, and none by as much as the step's lr."""
    from repro_torch.config import get_config, reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                decay_mask, init_opt_state,
                                                named_leaves, tree_map)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("mixtral-8x22b", "qwen2-moe-a2.7b"):
        cfg = reduced(get_config(name))
        batch = torch.from_numpy(SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=65, batch=4, seed=1)).batches(1)[0])
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        host = init_params(cfg, 0, device="cpu")
        start = tree_map(lambda t: t.to(dev, copy=True), host)
        out = {}
        for where, params in (("cuda", tree_map(lambda t: t.to(dev, copy=True), host)),
                              ("cpu", host)):
            for _, p in named_leaves(params):
                p.requires_grad_(True)
            step = make_train_step(cfg, opt_cfg, remat="none")
            with train_probe(torch, keep_grads=True) as rec:
                params, _, m = step(params, init_opt_state(params),
                                    batch.to(params["embed"].device))
            out[where] = (rec, m, {k: p.detach().cpu() for k, p in
                                   named_leaves(params)})
        (rc, mc, pc), (rh, mh, ph) = out["cuda"], out["cpu"]
        lr = float(mh["lr"])
        require(len(rc.routing) == len(rh.routing) == cfg.n_layers and all(
            torch.equal(a, b) for a, b in zip(rc.routing, rh.routing)),
            f"phase 8 {name}: routing differs between the card and the CPU")
        for key in ("loss", "aux"):
            a, b = float(mc[key]), float(mh[key])
            require(abs(a - b) <= 1e-5 * abs(b), f"phase 8 {name}: {key} {a} "
                    f"(card) vs {b} (CPU)")
        names = [k for k, _ in named_leaves(host)]
        g_worst = p_worst = s_worst = (0.0, "")
        n_off = 0
        for k, gc, gh in zip(names, rc.grads[0], rh.grads[0]):
            e = float((gc - gh).abs().max()) / max(float(gh.abs().max()), 1e-30)
            require(e <= 1e-4, f"phase 8 {name}: gradient {k} off by {e:.2e} of "
                    f"its max |g|")
            g_worst = max(g_worst, (e, k))
        adamw_update(opt_cfg, start, [g.to(dev) for g in rh.grads[0]],
                     init_opt_state(start), decay=decay_mask(start, cfg))
        for k, p in named_leaves(start):
            rng = float(ph[k].max() - ph[k].min()) or 1.0
            e = float((p.cpu() - ph[k]).abs().max()) / rng
            require(e <= 1e-5, f"phase 8 {name}: the card's update of the CPU's "
                    f"gradients gives {k} off by {e:.2e} of its range")
            p_worst = max(p_worst, (e, k))
            d = (pc[k] - ph[k]).abs()
            n_off += int((d > 1e-5 * rng).sum())
            s_worst = max(s_worst, (float(d.max()) / rng, k))
            require(float(d.max()) < lr, f"phase 8 {name}: the step moved {k} "
                    f"{float(d.max()):.2e} apart on the card and the CPU, past "
                    f"its lr {lr:.2e}")
        n_all = sum(t.numel() for t in ph.values())
        require(n_off <= 1e-4 * n_all, f"phase 8 {name}: {n_off} of {n_all} "
                f"elements of the step's params past 1e-5 of their range")
        print(f"phase 8(a) [{name}] f32 train step, card vs CPU: routing equal "
              f"over {cfg.n_layers} layers; loss {float(mc['loss']):.6f} / "
              f"{float(mh['loss']):.6f}, aux {float(mc['aux']):.6f} / "
              f"{float(mh['aux']):.6f}; worst gradient {g_worst[0]:.2e} of max "
              f"|g| ({g_worst[1]}); the update of the same gradients: worst "
              f"{p_worst[0]:.2e} of the range ({p_worst[1]}); the step's own: "
              f"{n_off} of {n_all} elements over 1e-5 of the range, worst "
              f"{s_worst[0]:.2e} ({s_worst[1]})")


def train_step_bound(cfg, batch, seq, n_params):
    """(forward + backward matmul FLOPs, update bytes) of one train step:
    3 x the forward's matmuls (the expert einsums over all E x C capacity
    rows, attention's scores over every key, the LM head; the chunked
    cross-entropy's recomputed head is left out), and the update reading
    p, g, mu and nu and writing p, mu and nu once, in f32."""
    from repro_torch.models.moe import expert_capacity
    BT, d, hd = batch * seq, cfg.d_model, cfg.resolved_head_dim
    H, Hkv, m = cfg.n_heads, cfg.n_kv_heads, cfg.moe
    C = expert_capacity(BT, m, "train")
    per_layer = (2 * BT * d * (2 * H * hd + 2 * Hkv * hd)        # q, k, v, o
                 + 4 * batch * H * seq * seq * hd                # scores, p @ v
                 + 2 * BT * d * m.n_experts                      # router
                 + 3 * 2 * m.n_experts * C * d * m.d_ff_expert)  # w1, w3, w2
    fwd = cfg.n_layers * per_layer + 2 * BT * d * cfg.vocab
    return 3 * fwd, 7 * 4 * n_params, C


def phase_train(torch, dev):
    """Phase 8(b) and (c): ``launch.train.run`` at mixtral-8x22b's
    published widths, cut to one layer, f32 (TF32 off): TRAIN's 10 steps
    with the launch counts set to 0 just before (the training path
    launches none of the kernels); ms/step (median of steps 3-10, CUDA
    events from the step's start to the update's end), tokens/s, forward
    + backward and update apart, peak memory, loss and grad norm per
    step, against the step's bound.  Every loss and grad norm finite, the
    mean loss of the last 3 steps below that of the first 3 and below the
    first step's (else one retry at AdamWConfig's default lr).  Then (c): on fresh params of the
    same seed and one batch, the loss with its backward at remat "none",
    then a train step at remat "full": losses within 1e-6 relative, and
    the memory the forward keeps for backward lower under "full"; the
    peak of each is printed."""
    from repro_torch.config import get_config
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch.train import run
    from repro_torch.models.transformer import init_params
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.loop import lm_loss, make_train_step
    from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                                leaves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T = TRAIN
    cfg = dataclasses.replace(get_config(T["arch"]), n_layers=T["n_layers"])
    n_params = cfg.param_count()
    flops, upd_bytes, C = train_step_bound(cfg, T["batch"], T["seq"], n_params)
    fb_bound = flops / PEAK_FLOPS["float32"] * 1e3
    upd_bound = upd_bytes / PEAK_BYTES_S * 1e3
    lr = T["lr"]
    for attempt in range(2):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with train_probe(torch, timed=True) as rec:
            losses = run(T["arch"], use_reduced=False, steps=T["steps"],
                         batch=T["batch"], seq=T["seq"], lr=lr, remat="none",
                         log_every=1, dtype="float32", seed=T["seed"], device=dev,
                         n_layers=T["n_layers"])
        torch.cuda.synchronize()
        launched = {k: v for k, v in launch_counts().items() if v}
        require(not launched, f"phase 8: the training path launched {launched}")
        peak = torch.cuda.max_memory_allocated()
        gnorms = [float(m["grad_norm"]) for m in rec.metrics]
        require(len(losses) == len(gnorms) == T["steps"], "phase 8: step count")
        require(all(map(math.isfinite, losses + gnorms)),
                f"phase 8: non-finite loss or grad norm {losses} {gnorms}")
        last3 = statistics.mean(losses[-3:])
        falls = last3 < statistics.mean(losses[:3]) and last3 < losses[0]
        if falls or attempt:
            break
        print(f"phase 8(b): the loss did not fall below its first 3 steps' "
              f"mean and its first step's at lr {lr} ({losses}); "
              f"retrying once at lr {TRAIN_RETRY_LR}")
        lr = TRAIN_RETRY_LR
    require(falls, f"phase 8: mean loss of the last 3 steps not below the first "
            f"3's and the first step's at lr {lr}: {losses}")
    step_ms = [s.elapsed_time(e) for s, _, e in rec.events]
    fb_ms = [s.elapsed_time(b) for s, b, _ in rec.events]
    upd_ms = [b.elapsed_time(e) for _, b, e in rec.events]
    med = lambda xs: statistics.median(xs[TIMED_STEPS])
    tok = T["batch"] * T["seq"]
    print(f"phase 8(b) {cfg.name} at published width ({cfg.n_layers} layer, "
          f"{n_params / 1e9:.3f} B params, f32, TF32 off), batch {T['batch']} x "
          f"seq {T['seq']}, remat none, lr {lr}: {med(step_ms):.2f} ms/step "
          f"(median of steps 3-{T['steps']}), {tok / med(step_ms) * 1e3:.1f} tok/s; "
          f"forward + backward {med(fb_ms):.2f} ms, update {med(upd_ms):.2f} ms "
          f"({med(upd_ms) / med(step_ms):.3f} of the step); peak memory "
          f"{peak / 1e9:.2f} GB")
    print(f"phase 8(b) per step: loss {[round(x, 4) for x in losses]}, grad norm "
          f"{[round(x, 4) for x in gnorms]}, ms {[round(x, 2) for x in step_ms]}")
    print(f"phase 8(b) bound: forward + backward {flops / 1e12:.3f} TFLOP (expert "
          f"capacity C = {C}) at {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s f32 = "
          f"{fb_bound:.2f} ms; update {upd_bytes / 1e9:.1f} GB at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s = {upd_bound:.2f} ms; measured / "
          f"bound: forward + backward {med(fb_ms) / fb_bound:.2f}x, update "
          f"{med(upd_ms) / upd_bound:.2f}x, step {med(step_ms) / (fb_bound + upd_bound):.2f}x")
    torch.cuda.empty_cache()

    # (c) remat "full" against "none" on the same params and batch
    params = init_params(cfg, T["seed"], torch.float32, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    toks = torch.from_numpy(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=T["seq"] + 1, batch=T["batch"],
        seed=T["seed"] + 1)).batches(1)[0]).to(dev)
    state = init_opt_state(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total, (loss_none, _) = lm_loss(params, cfg, toks, {}, remat="none")
    kept_none = torch.cuda.memory_allocated() - base
    total.backward()
    peak_none = torch.cuda.max_memory_allocated()
    for p in leaves(params):
        p.grad = None
    del total
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=2,
                                            total_steps=T["steps"]), remat="full")
    with train_probe(torch, timed=True) as rec:
        params, state, m = step(params, state, toks)
    torch.cuda.synchronize()
    peak_full = torch.cuda.max_memory_allocated()
    kept_full = rec.memory[0] - base
    a, b = float(m["loss"]), loss_none.item()
    require(abs(a - b) <= 1e-6 * abs(b), f"phase 8(c): remat full loss {a} vs none {b}")
    require(kept_full < kept_none, f"phase 8(c): remat full keeps {kept_full} B "
            f"for backward, none {kept_none} B")
    print(f"phase 8(c) remat full vs none (same params and batch): loss {a:.6f} / "
          f"{b:.6f}; kept for backward after the forward {kept_full / 1e9:.3f} / "
          f"{kept_none / 1e9:.3f} GB; step peak {peak_full / 1e9:.2f} / "
          f"{peak_none / 1e9:.2f} GB ({base / 1e9:.2f} GB of params and moments)")
    step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=2,
                                            total_steps=T["steps"]), remat="none")
    profile_train_step(torch, lambda: step(params, state, toks))
    del params, state, toks
    torch.cuda.empty_cache()


# kernel-name fragments by class, for the train step's device-time split
TRAIN_KERNEL_CLASSES = (("matmul", ("gemm", "xmma", "cutlass", "sm90", "sm80")),
                        ("index / scatter / gather", ("index", "scatter", "gather",
                                                      "embedding")),
                        ("reduction", ("reduce", "norm", "softmax")),
                        ("elementwise", ("elementwise", "vectorized", "foreach")))


def profile_train_step(torch, fn):
    """One more step under torch.profiler: the device's busy share of its
    wall time, device time by kernel class and the kernels that take the
    most of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_events(torch, prof)
    if not kernels:
        print("phase 8 profile: torch.profiler recorded no device time")
        return
    by_name, by_class = {}, {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        low = e.name.lower()
        cls = next((c for c, keys in TRAIN_KERNEL_CLASSES
                    if any(k in low for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_class.values())
    print(f"phase 8 profile (one step, remat none): {len(kernels)} device kernels, "
          f"{busy / 1e3:.2f} ms of device time in {wall_us / 1e3:.2f} ms wall "
          f"({busy / wall_us:.3f}); by class: " + ", ".join(
              f"{c} {us / 1e3:.2f} ms" for c, us in
              sorted(by_class.items(), key=lambda kv: -kv[1])))
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"phase 8 profile:   {us / 1e3:8.3f} ms = {n:4d} x {us / n:9.2f} us  "
              f"{name[:90]}")


def trace_decode(torch, eng, prompts):
    """Submit ``prompts`` (6 new tokens each), take one engine step
    (admission and prefill stay outside), then trace three decode
    iterations with torch.profiler.  Returns the profiler, the window's
    wall us, the gating_dispatch calls in it, the device ops and the
    device busy us (the union of kernel intervals on every stream)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.cuda_build import launch_counts
    from repro_torch.serving.engine import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=100 + i, prompt=list(p), max_new_tokens=6))
    eng.step()
    torch.cuda.synchronize()
    calls0 = launch_counts()["gating_dispatch"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    calls = launch_counts()["gating_dispatch"] - calls0
    eng.run_until_done()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events(torch, prof))
    require(bool(spans), "trace: the profiler recorded no device time")
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return types.SimpleNamespace(prof=prof, wall_us=wall_us, calls=calls,
                                 n_ops=len(spans), busy_us=busy)


def profile_decode(torch, eng, prompts, label="profile"):
    """Trace three decode iterations of a full batch (``trace_decode``):
    the device's busy share of the window and the kernels that take the
    most device time.  Returns the gating_dispatch calls of the window,
    their device kernels and those kernels' summed time (us)."""
    tr = trace_decode(torch, eng, prompts)
    prof, wall_us, calls, busy = tr.prof, tr.wall_us, tr.calls, tr.busy_us
    print(f"{label}: 3 decode iters in {wall_us / 1e3:.2f} ms wall, device busy "
          f"{busy / 1e3:.2f} ms = {busy / wall_us:.3f} of the window "
          f"({tr.n_ops} device ops)")
    # each gating_dispatch call of the decode step (T = 4) is one kernel
    gd = [e.time_range.elapsed_us() for e in device_events(torch, prof)
          if "gating_dispatch" in e.name]
    gd_kernels = len(gd)
    print(f"{label}: gating_dispatch {calls} calls, {gd_kernels} device kernels, "
          f"{sum(gd) / max(1, gd_kernels):.2f} us each")
    require(calls > 0 and gd_kernels == calls,
            f"{label}: {gd_kernels} gating_dispatch kernels for {calls} calls")
    by_name = {}
    for e in device_events(torch, prof):
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top 8, and every launch of the port's attention and gating kernels
    shown = ranked[:8] + [kv for kv in ranked[8:]
                          if "attention" in kv[0] or "gating" in kv[0]]
    for name, (us, n) in shown:
        print(f"{label}:   {us / 1e3:8.3f} ms = {n:4d} x {us / n:8.2f} us  {name[:80]}")
    return dict(calls=calls, kernels=gd_kernels, us=sum(gd), busy_ms=busy / 1e3,
                window_ms=wall_us / 1e3)


# phase 9: the multi-process slice on one card.  Every rank is a process
# of its own on cuda:0 and the ranks meet over gloo (NCCL refuses two
# ranks on one device; gloo stages CUDA tensors through the host).
P9_MOE = dict(d=6144, n_experts=8, top_k=2, d_ff=16384)   # mixtral-8x22b's layer
P9_TOKENS = (4, 8)
P9_REPS = 10
P9_RANKS = 2
P9_TIMEOUT = 300           # seconds for all ranks of one sub-phase
# 9(c): one full-width qwen2-moe layer takes 19.1 GB of params, grads and
# moments per rank; mixtral-8x22b's (46.4 GB, phase 8) does not fit twice
# on one card, so data parallelism at its width needs a card per rank
P9_TRAIN = dict(arch="qwen2-moe-a2.7b", n_layers=1, batch=8, seq=128, steps=3,
                lr=1e-3, seed=0)
P9_STAGE_MB = 256          # the all_reduce size whose host staging is timed


def p9_layer(torch, dev, lo, hi, dtype):
    """Experts [lo, hi) of phase 9(a)'s layer (each drawn from a seed of
    its own, so a rank draws its slice as the whole layer has it), the
    f32 router and 8 tokens in ``dtype``."""
    d, f = P9_MOE["d"], P9_MOE["d_ff"]
    w = {"we1": torch.empty((hi - lo, d, f), device=dev),
         "we3": torch.empty((hi - lo, d, f), device=dev),
         "we2": torch.empty((hi - lo, f, d), device=dev)}
    for i, e in enumerate(range(lo, hi)):
        g = torch.Generator(device=dev).manual_seed(1000 + e)
        for k, fan_in in (("we1", d), ("we3", d), ("we2", f)):
            w[k][i].normal_(generator=g).div_(math.sqrt(fan_in))
    g = torch.Generator(device=dev).manual_seed(999)
    router = torch.randn((d, P9_MOE["n_experts"]), generator=g, device=dev) / math.sqrt(d)
    x = torch.randn((max(P9_TOKENS), d), generator=g, device=dev)
    return {k: v.to(dtype) for k, v in w.items()}, router, x.to(dtype)


def p9_cfg():
    from repro_torch.config import MoEConfig
    return MoEConfig(n_experts=P9_MOE["n_experts"], top_k=P9_MOE["top_k"],
                     d_ff_expert=P9_MOE["d_ff"])


class p9_timer:
    """Within the block, wrap ``kops.gating_dispatch``, ``kops.grouped_mlp``
    and ``mesh.all_reduce`` (when a mesh is given) with CUDA events, and the
    all_reduce also with the host clock between two synchronizes; ``take()``
    returns and clears the device times (ms) per name since the last call."""

    def __init__(self, torch, mesh=None):
        from repro_torch.kernels import ops as kops
        self.torch, self.kops, self.mesh = torch, kops, mesh
        self.events, self.host = {}, []

    def _wrap(self, name, fn):
        torch = self.torch

        def timed(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            if name == "all_reduce":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            s.record()
            out = fn(*a, **kw)
            e.record()
            if name == "all_reduce":
                torch.cuda.synchronize()
                self.host.append((time.perf_counter() - t0) * 1e3)
            self.events.setdefault(name, []).append((s, e))
            return out
        return timed

    def __enter__(self):
        self.saved = (self.kops.gating_dispatch, self.kops.grouped_mlp)
        self.kops.gating_dispatch = self._wrap("dispatch", self.saved[0])
        self.kops.grouped_mlp = self._wrap("mlp", self.saved[1])
        if self.mesh is not None:
            self.mesh.all_reduce = self._wrap("all_reduce", self.mesh.all_reduce)
        return self

    def __exit__(self, *exc):
        self.kops.gating_dispatch, self.kops.grouped_mlp = self.saved
        if self.mesh is not None:
            del self.mesh.all_reduce

    def take(self):
        self.torch.cuda.synchronize()
        out = {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}
        if self.host:
            out["all_reduce_host"] = self.host
        self.events, self.host = {}, []
        return out


def p9_m2n_child(torch, out_dir):
    """Phase 9(a), one rank: expert shard j (experts [4 j, 4 j + 4)) of
    mixtral's layer, f32 (TF32 off) then bf16, at T = 4 and 8 in the
    engine's drop-free capacity mode; P9_REPS timed calls of each after 2
    warm-up calls, all ranks at once.  The ranks share the card, so the
    CUDA events of those calls span the other ranks' kernels too; each
    rank then runs P9_REPS more calls alone on the card (the others wait
    at a barrier), its combine's all_reduce left out, which time its own
    kernels.  Saves y and the counts, prints one JSON line."""
    import torch.distributed as dist

    from repro_torch.core.m2n import sharded_routed_experts
    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = MultiControllerTransport(device="cuda")
    mesh = make_mesh((tr.process_count,), ("model",))
    j, n = mesh.index("model"), mesh.size("model")
    e_loc = P9_MOE["n_experts"] // n
    cfg = p9_cfg()
    reset_launch_counts()
    calls, saved, times = 0, {}, {}
    w, router, x = p9_layer(torch, tr.device, j * e_loc, (j + 1) * e_loc,
                            torch.float32)
    weights_gb = sum(t.numel() * t.element_size() for t in w.values()) / 1e9
    for dtype in ("float32", "bfloat16"):
        params = dict({k: v.to(getattr(torch, dtype)) for k, v in w.items()},
                      router=router)
        if dtype == "bfloat16":
            del w
        for T in P9_TOKENS:
            xs = x[:T].to(getattr(torch, dtype))
            call = lambda: sharded_routed_experts(
                params, xs, cfg, "silu", "full", mesh=mesh, expert_axis="model",
                with_counts=True, transport=tr)
            with p9_timer(torch, mesh) as tm:
                for _ in range(2):
                    call()
                tm.take()
                wall = []
                for _ in range(P9_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y, counts = call()
                    torch.cuda.synchronize()
                    wall.append((time.perf_counter() - t0) * 1e3)
                dev_ms = tm.take()
            calls += 2 + P9_REPS
            saved[f"{dtype}/{T}"] = (y.float().cpu(), counts.cpu())
            times[f"{dtype}/{T}"] = {k: statistics.median(v) for k, v in dev_ms.items()}
            times[f"{dtype}/{T}"]["wall"] = statistics.median(wall)
            for r in range(n):
                dist.barrier()
                if r != j:
                    continue
                mesh.all_reduce = lambda t, axes: t
                with p9_timer(torch) as tm:
                    call()
                    tm.take()
                    wall = []
                    for _ in range(P9_REPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        call()
                        torch.cuda.synchronize()
                        wall.append((time.perf_counter() - t0) * 1e3)
                    solo = tm.take()
                del mesh.all_reduce
                calls += 1 + P9_REPS
                times[f"{dtype}/{T}"]["alone"] = dict(
                    {k: statistics.median(v) for k, v in solo.items()},
                    wall=statistics.median(wall))
            dist.barrier()
            # the host staging of the combine's all_reduce: the same bytes
            # as a CPU tensor over the same group
            cpu = torch.zeros((T, P9_MOE["d"]))
            host = []
            for _ in range(P9_REPS):
                t0 = time.perf_counter()
                mesh.all_reduce(cpu, "model")
                host.append((time.perf_counter() - t0) * 1e3)
            times[f"{dtype}/{T}"]["all_reduce_cpu_host"] = statistics.median(host)
        del params
    staging = {}
    n_el = P9_STAGE_MB * 2 ** 20 // 4
    for where in ("cuda", "cpu"):
        t = torch.ones(n_el, device=tr.device if where == "cuda" else "cpu")
        mesh.all_reduce(t, "model")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.all_reduce(t, "model")
        torch.cuda.synchronize()
        staging[where] = (time.perf_counter() - t0) * 1e3
        del t
    torch.save(saved, Path(out_dir) / f"m2n{j}.pt")
    print("phase9 " + json.dumps({
        "rank": j, "device": str(tr.device), "backend": tr.backend,
        "calls": calls, "launches": launch_counts(), "times": times,
        "staging_ms": staging, "weights_gb": weights_gb,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)


def p9_dp_child(torch, out_dir):
    """Phase 9(c), one rank: P9_TRAIN's steps data-parallel over the
    ranks (each takes batch / R rows; f32, TF32 off), timing each step
    and the gradient all_reduce.  Rank 0 keeps step 0's averaged
    gradients and updated params, frees the rest once every rank is done,
    runs the one-process step on the whole batch from the same params
    and holds the two against each other.  Prints one JSON line."""
    import torch.distributed as dist

    from repro_torch.config import get_config
    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.training import data_parallel as dp
    from repro_torch.training import loop
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                                named_leaves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = MultiControllerTransport(device="cuda")
    group = make_mesh((tr.process_count, 1), ("data", "model")).group("data")
    rank, P = tr.process_index, P9_TRAIN
    cfg = dataclasses.replace(get_config(P["arch"]), n_layers=P["n_layers"])
    opt = AdamWConfig(lr=P["lr"], warmup_steps=2, total_steps=P["steps"])
    batches = [torch.from_numpy(b).to(tr.device) for b in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=P["seq"] + 1, batch=P["batch"],
        seed=P["seed"])).batches(P["steps"])]

    def train(group, keep):
        """(metrics per step, ms per step, all_reduce ms per step, step 0's
        gradients and params when ``keep``)."""
        params = init_params(cfg, P["seed"], torch.float32, device=tr.device)
        names = [k for k, _ in named_leaves(params)]
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        if group is not None:
            dp.check_replicated([p for _, p in named_leaves(params)] + batches,
                                group, "params and batches")
        state = init_opt_state(params)
        step = loop.make_train_step(cfg, opt, remat="none", group=group)
        kept, ar_ms, ms, metrics = {}, [], [], []
        update, average = loop.adamw_update, dp.average_grads

        def keep_grads(opt_cfg, ps, grads, st, **kw):
            if keep and not kept:
                kept["grads"] = dict(zip(names, (g.clone() for g in grads)))
            return update(opt_cfg, ps, grads, st, **kw)

        def timed_average(grads, g):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            average(grads, g)
            torch.cuda.synchronize()
            ar_ms.append((time.perf_counter() - t0) * 1e3)

        loop.adamw_update, dp.average_grads = keep_grads, timed_average
        try:
            for s, toks in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, toks)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
                if keep and s == 0:
                    kept["params"] = {k: p.detach().clone()
                                      for k, p in named_leaves(params)}
        finally:
            loop.adamw_update, dp.average_grads = update, average
        return metrics, ms, ar_ms, kept

    torch.cuda.reset_peak_memory_stats()
    metrics, ms, ar_ms, kept = train(group, keep=rank == 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"rank": rank, "metrics": metrics, "ms": ms, "all_reduce_ms": ar_ms,
           "peak_gb": peak}
    dist.barrier(group)                 # every rank is done with its state
    if rank == 0:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ref, ref_ms, _, ref_kept = train(None, keep=True)
        out.update(ref_metrics=ref, ref_ms=ref_ms,
                   ref_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        g_worst, n_off, n_all, p_worst, p_moved = (0.0, ""), 0, 0, (0.0, ""), 0.0
        for k, g in kept["grads"].items():
            w = ref_kept["grads"][k]
            e = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            g_worst = max(g_worst, (e, k))
        for k, p in kept["params"].items():
            w = ref_kept["params"][k]
            d = (p - w).abs()
            rng = float(w.max() - w.min()) or 1.0
            n_off += int((d > 1e-5 * rng).sum())
            n_all += d.numel()
            p_worst = max(p_worst, (float(d.max()) / rng, k))
            p_moved = max(p_moved, float(d.max()))
        out.update(grad_worst=g_worst, params_off=n_off, params_all=n_all,
                   params_worst=p_worst, params_max_abs=p_moved)
    print("phase9 " + json.dumps(out), flush=True)


def p9_results(torch, label, out, n):
    """The ``phase9 {...}`` line of each of ``n`` ranks of ``run_ranks``'s
    output; every rank must have exited 0 and printed one."""
    got = []
    for rank, (rc, text) in enumerate(out):
        require(rc == 0, f"phase 9{label}: rank {rank} exited {rc}:\n{text[-4000:]}")
        lines = [ln for ln in text.splitlines() if ln.startswith("phase9 ")]
        require(len(lines) == 1, f"phase 9{label}: rank {rank} printed no result:\n"
                f"{text[-4000:]}")
        got.append(json.loads(lines[0][len("phase9 "):]))
    require(len(got) == n, f"phase 9{label}: {len(got)} of {n} ranks")
    return got


def phase_processes(torch, dev):
    """Phase 9: (a) the M2N dispatch of mixtral-8x22b's MoE layer over two
    processes on the card, against the plain ``routed_experts_dense`` of
    one process; (b) ``repro_torch.launch.dist_smoke --procs 2`` on the
    card; (c) data-parallel training of qwen2-moe-a2.7b at published width
    (1 layer) over two processes against one process on the whole batch.
    Returns each rank's launches of phase 9(a):
    {"gating_dispatch[owner]": [...], "grouped_matmul": [...]}."""
    from repro_torch.core.m2n import sharded_routed_experts
    from repro_torch.models import moe as moe_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "build" / "phase9"
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = p9_cfg()
    E, d = P9_MOE["n_experts"], P9_MOE["d"]

    # (a) the reference of one process: the plain dense routed experts,
    # and the same dispatch as two shards in one process, timed
    w, router, x = p9_layer(torch, dev, 0, E, torch.float32)
    refs, one = {}, {}
    for dtype in ("float32", "bfloat16"):
        params = dict({k: v.to(getattr(torch, dtype)) for k, v in w.items()},
                      router=router)
        for T in P9_TOKENS:
            xs = x[:T].to(getattr(torch, dtype))
            y, _ = moe_lib.routed_experts_dense(params, xs, cfg, "silu", "full")
            r = moe_lib.route(xs, router, cfg.top_k)
            refs[f"{dtype}/{T}"] = (y.float().cpu(),
                                    moe_lib.routing_counts(r, E).cpu())
            call = lambda: sharded_routed_experts(params, xs, cfg, "silu", "full",
                                                  n_shards=P9_RANKS)
            with p9_timer(torch) as tm:
                call()
                tm.take()
                wall = []
                for _ in range(P9_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    wall.append((time.perf_counter() - t0) * 1e3)
                dev_ms = tm.take()
            one[f"{dtype}/{T}"] = {k: statistics.median(v) for k, v in dev_ms.items()}
            one[f"{dtype}/{T}"]["wall"] = statistics.median(wall)
        del params
    del w
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = p9_results(torch, "(a)", run_ranks(
        [str(ROOT / "chip_smoke.py"), "--phase9", "m2n", str(out_dir)], P9_RANKS,
        timeout=P9_TIMEOUT), P9_RANKS)
    t_a = time.perf_counter() - t0
    launches = {"gating_dispatch[owner]": [], "grouped_matmul": []}
    for got in ranks:
        j = got["rank"]
        saved = torch.load(out_dir / f"m2n{j}.pt")
        lc = got["launches"]
        require(lc["gating_dispatch[owner]"] >= got["calls"] and
                lc["grouped_matmul"] >= 2 * got["calls"],
                f"phase 9(a) rank {j}: {got['calls']} dispatches launched {lc}")
        for name in launches:
            launches[name].append(lc[name])
        for key, (y_ref, c_ref) in refs.items():
            y, counts = saved[key]
            require(torch.equal(counts, c_ref),
                    f"phase 9(a) rank {j} {key}: counts {counts} vs {c_ref}")
            if key.startswith("float32"):
                rng = float(y_ref.max() - y_ref.min())
                err = max_err(torch, y, y_ref)
                require(err <= 1e-5 * rng, f"phase 9(a) rank {j} {key}: y off by "
                        f"{err:.3e}, range {rng:.3e}")
            else:
                check_close(torch, f"phase 9(a) rank {j} {key}", y, y_ref, 2e-2, 2e-2)
        for key, t in got["times"].items():
            o, a = one[key], t["alone"]
            print(f"phase 9(a) rank {j} {key.replace('/', ' T=')}: alone on the "
                  f"card: dispatch {a['dispatch']:.4f} ms, expert MLP {a['mlp']:.4f} "
                  f"ms, shard call without the combine {a['wall']:.4f} ms; both "
                  f"ranks at once (shared-card spans, each holds the other rank's "
                  f"kernels too): dispatch {t['dispatch']:.4f} ms, MLP {t['mlp']:.4f} "
                  f"ms, all_reduce {t['all_reduce']:.4f} ms device / "
                  f"{t['all_reduce_host']:.4f} ms host (a CPU tensor: "
                  f"{t['all_reduce_cpu_host']:.4f} ms), call {t['wall']:.4f} ms; "
                  f"one process, 2 shards: dispatch {o['dispatch']:.4f} ms x2, "
                  f"MLP {o['mlp']:.4f} ms x2, call {o['wall']:.4f} ms")
        print(f"phase 9(a) rank {j} on {got['device']} over {got['backend']}: "
              f"{got['weights_gb']:.2f} GB of f32 experts, peak {got['peak_gb']:.2f} GB; "
              f"{got['calls']} dispatches launched gating_dispatch[owner] "
              f"{lc['gating_dispatch[owner]']}, grouped_matmul {lc['grouped_matmul']}; "
              f"a {P9_STAGE_MB} MiB all_reduce: {got['staging_ms']['cuda']:.1f} ms "
              f"on the card, {got['staging_ms']['cpu']:.1f} ms on the host")
    print(f"phase 9(a): y and counts of both ranks hold against the plain "
          f"routed_experts_dense of one process (f32 1e-5 of the range, bf16 "
          f"2e-2); {t_a:.1f} s with the ranks' start")

    # (b) the port's dist_smoke on the card
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dist_smoke",
                        "--procs", str(P9_RANKS), "--timeout", str(P9_TIMEOUT)],
                       env=dict(os.environ, PYTHONPATH=str(SRC)),
                       capture_output=True, text=True, timeout=P9_TIMEOUT + 60)
    require(r.returncode == 0, f"phase 9(b): dist_smoke exited {r.returncode}:\n"
            f"{r.stdout[-4000:]}\n{r.stderr[-2000:]}")
    for pid in range(P9_RANKS):
        require(f"dist-smoke OK p{pid}/{P9_RANKS} device=cuda:0 transport=multi "
                f"backend=gloo" in r.stdout, f"phase 9(b): no OK line of rank {pid}:\n"
                f"{r.stdout[-4000:]}")
    smoke = [json.loads(ln[len("launches "):]) for ln in r.stdout.splitlines()
             if ln.startswith("launches ")]
    require(len(smoke) == P9_RANKS and all(
        c["gating_dispatch[owner]"] >= 1 and c["grouped_matmul"] >= 3 for c in smoke),
        f"phase 9(b): launches per rank {smoke}")
    print(f"phase 9(b) dist_smoke --procs {P9_RANKS} on the card: OK in "
          f"{time.perf_counter() - t0:.1f} s; launches per rank "
          f"{[(c['gating_dispatch[owner]'], c['grouped_matmul']) for c in smoke]}")

    # (c) data-parallel training against one process
    t0 = time.perf_counter()
    ranks = p9_results(torch, "(c)", run_ranks(
        [str(ROOT / "chip_smoke.py"), "--phase9", "dp", str(out_dir)], P9_RANKS,
        timeout=P9_TIMEOUT), P9_RANKS)
    P = P9_TRAIN
    r0 = next(g for g in ranks if g["rank"] == 0)
    ref = r0["ref_metrics"]
    for g in ranks:
        for s, (m, w) in enumerate(zip(g["metrics"], ref)):
            for key in ("loss", "aux"):
                require(abs(m[key] - w[key]) <= 1e-5 * abs(w[key]),
                        f"phase 9(c) rank {g['rank']} step {s}: {key} {m[key]} vs "
                        f"{w[key]} (one process)")
            require(m["dropped"] > 0, f"phase 9(c) step {s}: no token dropped")
    require(r0["grad_worst"][0] <= 1e-4, f"phase 9(c): gradient {r0['grad_worst'][1]} "
            f"off by {r0['grad_worst'][0]:.2e} of its max |g|")
    lr = float(ranks[0]["metrics"][0]["lr"])
    require(r0["params_off"] <= 1e-4 * r0["params_all"] and r0["params_max_abs"] < lr,
            f"phase 9(c): the step's params: {r0['params_off']} of "
            f"{r0['params_all']} elements past 1e-5 of the range, worst "
            f"{r0['params_max_abs']:.2e} (lr {lr:.2e})")
    med = lambda xs: statistics.median(xs[1:])
    tok = P["batch"] * P["seq"]
    for g in sorted(ranks, key=lambda g: g["rank"]):
        print(f"phase 9(c) rank {g['rank']}: {med(g['ms']):.2f} ms/step (median of "
              f"steps 2-{P['steps']}), gradient all_reduce {med(g['all_reduce_ms']):.2f} "
              f"ms ({med(g['all_reduce_ms']) / med(g['ms']):.3f} of the step), peak "
              f"{g['peak_gb']:.2f} GB; ms {[round(x, 1) for x in g['ms']]}, "
              f"dropped {[m['dropped'] for m in g['metrics']]}")
    print(f"phase 9(c) {P['arch']} at published width ({P['n_layers']} layer, f32, "
          f"TF32 off), batch {P['batch']} x seq {P['seq']} split over {P9_RANKS} "
          f"ranks on one card: losses {[round(m['loss'], 6) for m in r0['metrics']]} "
          f"vs one process {[round(m['loss'], 6) for m in ref]}, aux "
          f"{[round(m['aux'], 6) for m in r0['metrics']]} vs "
          f"{[round(m['aux'], 6) for m in ref]}; worst gradient "
          f"{r0['grad_worst'][0]:.2e} of max |g| ({r0['grad_worst'][1]}); the step's "
          f"params: {r0['params_off']} of {r0['params_all']} elements past 1e-5 of "
          f"the range, worst {r0['params_worst'][0]:.2e} ({r0['params_worst'][1]}); "
          f"one process {med(r0['ref_ms']):.2f} ms/step, {tok / med(r0['ref_ms']) * 1e3:.1f} "
          f"tok/s, peak {r0['ref_peak_gb']:.2f} GB; {time.perf_counter() - t0:.1f} s "
          f"with the ranks' start")
    return launches


# phase 10: the model axis.  Training on a ("data", "model") grid of
# processes, every rank holding its blocks of the params under the JAX
# "ep" rules (launch/sharding.py) and computing tensor- and
# expert-parallel over "model" (models/parallel.py).  On one card every
# rank is a process on cuda:0 over gloo; where there is a card per rank
# (a four-card machine) the ranks take one each and meet over NCCL.
# (a): mixtral-8x22b at published width, one layer, on a (1, 2) grid:
# 23.2 GB of params, grads and moments per rank; (b): qwen2-moe-a2.7b at
# published width, one layer, on a (2, 2) grid, 9.6 GB per rank, its 60
# experts expert-parallel over m = 2.
P10 = {"a": dict(arch="mixtral-8x22b", grid=(1, 2), loss_rtol=1e-6, grad_tol=1e-5),
       "b": dict(arch="qwen2-moe-a2.7b", grid=(2, 2), loss_rtol=1e-5, grad_tol=1e-4)}
P10_RUN = dict(n_layers=1, batch=8, seq=128, steps=3, lr=1e-3, seed=0)
P10_TIMEOUT = 300          # seconds for all ranks of one sub-phase


def p10_setup(torch, which, dev):
    """(config, AdamW config, the steps' batches on ``dev``) of 10(which)."""
    from repro_torch.config import get_config
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    R = P10_RUN
    cfg = dataclasses.replace(get_config(P10[which]["arch"]), n_layers=R["n_layers"])
    opt = AdamWConfig(lr=R["lr"], warmup_steps=2, total_steps=R["steps"])
    batches = [torch.from_numpy(b).to(dev) for b in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=R["seq"] + 1, batch=R["batch"],
        seed=R["seed"])).batches(R["steps"])]
    return cfg, opt, batches


def p10_one_process(torch, which, dev):
    """10(which) in one process on the whole batch: the metrics of each
    step, ms per step (host clock, synchronized), peak memory."""
    from repro_torch.models.transformer import init_params
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import init_opt_state, leaves
    cfg, opt, batches = p10_setup(torch, which, dev)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, P10_RUN["seed"], torch.float32, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    state = init_opt_state(params)
    step = make_train_step(cfg, opt, remat="none")
    metrics, ms = [], []
    for toks in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, toks)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, state
    torch.cuda.empty_cache()
    return metrics, ms, peak


def p10_child(torch, which, out_dir):
    """One rank of 10(which): its blocks of the ``init_params`` draw (each
    leaf cut to them as it is drawn), the steps on the grid
    with the model-axis collectives and the data-axis gradient
    all_reduce timed on the host clock (each between two synchronizes),
    the launch counts set to 0 before and read after.  Then, one rank at
    a time (the others at a barrier), the one-process gradient of step 0
    on the whole batch, against which the rank holds its block of step
    0's gradients.  Prints one JSON line."""
    import torch.distributed as dist

    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.training import data_parallel as dp
    from repro_torch.training import loop
    from repro_torch.training.optimizer import init_opt_state, leaves, named_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = MultiControllerTransport(device="cuda")
    rank, n = tr.process_index, tr.process_count
    mesh = make_mesh(P10[which]["grid"], ("data", "model"), device=tr.device)
    cfg, opt, batches = p10_setup(torch, which, tr.device)
    specs = sharding.param_specs(cfg, init_params(cfg, device="meta"), mesh)
    # each leaf cut to the rank's block as soon as it is drawn
    params = init_params(cfg, P10_RUN["seed"], torch.float32, device=tr.device,
                         place=sharding.Layout(cfg, mesh).place)
    torch.cuda.reset_peak_memory_stats()
    for p in leaves(params):
        p.requires_grad_(True)
    state = init_opt_state(params)
    state_gb = 4 * sum(p.numel() * p.element_size() for p in leaves(params)) / 1e9
    step = loop.make_train_step(cfg, opt, remat="none", mesh=mesh)
    coll_ms, ar_ms, kept = [], [], []
    update, average, mesh_all_reduce = loop.adamw_update, dp.average_grads, mesh.all_reduce

    def timed_all_reduce(t, axes, op="sum"):
        # the model axis' collectives (ModelParallel's and the norm's)
        if axes != "model":
            return mesh_all_reduce(t, axes, op)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_all_reduce(t, axes, op)
        torch.cuda.synchronize()
        coll_ms[-1] += (time.perf_counter() - t0) * 1e3
        return t

    def timed_average(grads, g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average(grads, g)
        torch.cuda.synchronize()
        ar_ms[-1] += (time.perf_counter() - t0) * 1e3

    def keep_grads(opt_cfg, ps, grads, st, **kw):
        if not kept:
            kept.extend(g.clone() for g in grads)
        return update(opt_cfg, ps, grads, st, **kw)

    loop.adamw_update, dp.average_grads = keep_grads, timed_average
    mesh.all_reduce = timed_all_reduce
    metrics, ms = [], []
    reset_launch_counts()
    try:
        for toks in batches:
            coll_ms.append(0.0)
            ar_ms.append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, toks)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        loop.adamw_update, dp.average_grads = update, average
        del mesh.all_reduce
    launches = dict(launch_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    names = [k for k, _ in named_leaves(params)]
    flat = [sp for _, sp in sharding.named_specs(specs)]
    del params, state
    torch.cuda.empty_cache()
    worst = (0.0, "")
    for r in range(n):
        dist.barrier()
        if r != rank:
            continue
        ref = init_params(cfg, P10_RUN["seed"], torch.float32, device=tr.device)
        for p in leaves(ref):
            p.requires_grad_(True)
        loop.lm_loss(ref, cfg, batches[0], {}, "none")[0].backward()
        for k, g, p, sp in zip(names, kept, leaves(ref), flat, strict=True):
            e = float((g - sharding.local_shard(p.grad, sp, mesh)).abs().max())
            worst = max(worst, (e / max(float(p.grad.abs().max()), 1e-30), k))
        del ref
        torch.cuda.empty_cache()
    dist.barrier()
    print("phase10 " + json.dumps({
        "rank": rank, "device": str(tr.device), "backend": tr.backend,
        "metrics": metrics, "ms": ms, "model_collectives_ms": coll_ms,
        "grad_all_reduce_ms": ar_ms, "peak_gb": peak, "state_gb": state_gb,
        "grad_worst": worst, "launches": launches}), flush=True)


def phase_model_axis(torch, dev):
    """Phase 10: (a) and (b), each first in one process on the whole batch
    (its memory freed after), then on its grid of processes: every rank's
    losses and aux against the one process's (a: 1e-6 relative, b: 1e-5:
    the data split sums the batch in another order), entries dropped in
    every step, each rank's block of step 0's gradients against the
    one-process gradient (a: 1e-5, b: 1e-4 of each leaf's max |g|), no
    kernel launched; ms/step, the model-axis collectives' and the
    data-axis gradient all_reduce's shares of it, peak memory per rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "build" / "phase10"
    out_dir.mkdir(parents=True, exist_ok=True)
    med = lambda xs: statistics.median(xs[1:])
    for which in ("a", "b"):
        P, R = P10[which], P10_RUN
        t0 = time.perf_counter()
        ref, ref_ms, ref_peak = p10_one_process(torch, which, dev)
        n = P["grid"][0] * P["grid"][1]
        out = run_ranks([str(ROOT / "chip_smoke.py"), "--phase10", which,
                         str(out_dir)], n, timeout=P10_TIMEOUT)
        ranks = []
        for rank, (rc, text) in enumerate(out):
            require(rc == 0, f"phase 10({which}): rank {rank} exited {rc}:\n"
                    f"{text[-4000:]}")
            lines = [ln for ln in text.splitlines() if ln.startswith("phase10 ")]
            require(len(lines) == 1, f"phase 10({which}): rank {rank} printed "
                    f"no result:\n{text[-4000:]}")
            ranks.append(json.loads(lines[0][len("phase10 "):]))
        for g in ranks:
            for s, (m, w) in enumerate(zip(g["metrics"], ref, strict=True)):
                for key in ("loss", "aux"):
                    require(abs(m[key] - w[key]) <= P["loss_rtol"] * abs(w[key]),
                            f"phase 10({which}) rank {g['rank']} step {s}: {key} "
                            f"{m[key]} vs {w[key]} (one process)")
                require(m["dropped"] > 0, f"phase 10({which}) step {s}: no entry "
                        f"dropped")
            require(g["grad_worst"][0] <= P["grad_tol"], f"phase 10({which}) rank "
                    f"{g['rank']}: gradient {g['grad_worst'][1]} off by "
                    f"{g['grad_worst'][0]:.2e} of its max |g|")
            require(not any(g["launches"].values()),
                    f"phase 10({which}): the training path launched {g['launches']}")
        tok = R["batch"] * R["seq"]
        for g in sorted(ranks, key=lambda g: g["rank"]):
            step = med(g["ms"])
            print(f"phase 10({which}) rank {g['rank']} on {g['device']} over "
                  f"{g['backend']}: {step:.2f} ms/step (median of steps 2-"
                  f"{R['steps']}), model-axis collectives "
                  f"{med(g['model_collectives_ms']):.2f} ms "
                  f"({med(g['model_collectives_ms']) / step:.3f} of the step), "
                  f"data-axis gradient all_reduce {med(g['grad_all_reduce_ms']):.2f} "
                  f"ms ({med(g['grad_all_reduce_ms']) / step:.3f}); "
                  f"{g['state_gb']:.2f} GB of params, grads and moments, peak "
                  f"{g['peak_gb']:.2f} GB; worst gradient {g['grad_worst'][0]:.2e} "
                  f"of max |g| ({g['grad_worst'][1]}); ms "
                  f"{[round(x, 1) for x in g['ms']]}")
        r0 = next(g for g in ranks if g["rank"] == 0)
        print(f"phase 10({which}) {P['arch']} at published width ({R['n_layers']} "
              f"layer, f32, TF32 off), batch {R['batch']} x seq {R['seq']} on a "
              f"{tuple(P['grid'])} (data, model) grid: losses "
              f"{[m['loss'] for m in r0['metrics']]} vs one process "
              f"{[m['loss'] for m in ref]}, aux {[m['aux'] for m in r0['metrics']]} "
              f"vs {[m['aux'] for m in ref]}, dropped "
              f"{[m['dropped'] for m in r0['metrics']]}; one process "
              f"{med(ref_ms):.2f} ms/step ({tok / med(ref_ms) * 1e3:.1f} tok/s), "
              f"peak {ref_peak:.2f} GB; {time.perf_counter() - t0:.1f} s with the "
              f"one-process run and the ranks' start")


# ---------------------------------------------------------------------------
# phase 11: prefill and decode on a rank's shards
# ---------------------------------------------------------------------------

# (a) the head split: mixtral's 8 kv heads over m = 2 (24 query heads, 4
# kv heads and 4 experts a rank), the experts as m2n shards over "model"
# (the kernel path: gating_dispatch's owner branch and grouped_matmul);
# (b) the slot split: minitron-4b's 8 kv heads do not divide m = 3, so
# each rank holds every kv head on 64 of the ring's 192 slots; prompts of
# 150 tokens and 32 steps reach all three blocks.  Published widths, cut
# in depth only: bf16 at 4 layers (and f32 at 2 for the exact check)
P11 = {"a": dict(arch="mixtral-8x22b", grid=(1, 2), prompt_len=16, max_seq=64,
                 m2n=True),
       "b": dict(arch="minitron-4b", grid=(1, 3), prompt_len=150, max_seq=192,
                 m2n=False)}
P11_RUN = dict(batch=8, steps=32, bf16_layers=4, f32_layers=2, seed=0)
P11_TIMEOUT = 240          # seconds for all ranks of one sub-phase


def p11_cfg(which, n_layers):
    from repro_torch.config import get_config
    return dataclasses.replace(get_config(P11[which]["arch"]), n_layers=n_layers)


def p11_prompts(torch, which, cfg, dev):
    gen = torch.Generator(device="cpu").manual_seed(11)
    return torch.randint(2, cfg.vocab, (P11_RUN["batch"], P11[which]["prompt_len"]),
                         generator=gen).to(dev)


def p11_predicted(which, n_layers, bf16=False):
    """Host launches of one rank's prefill and decode steps, by kernel: a
    decode attention (the partial branch where the slots split) per layer
    and step; under m2n one dispatch (the owner branch) and three grouped
    matmuls per layer and pass (prefill included), each given its slot
    table, and in bf16 the prefill's (full capacity: batch x prompt rows)
    on the live-row body."""
    from repro_torch.kernels.grouped_matmul import FMA_MAX_M
    L, S = n_layers, P11_RUN["steps"]
    out = {"decode_attention": L * S,
           "decode_attention[partial]": L * S if which == "b" else 0}
    if P11[which]["m2n"]:
        rows = P11_RUN["batch"] * P11[which]["prompt_len"]
        out.update({"gating_dispatch": L * (S + 1),
                    "gating_dispatch[owner]": L * (S + 1),
                    "grouped_matmul": 3 * L * (S + 1),
                    "grouped_matmul[live_rows]": 3 * L * (S + 1),
                    "grouped_matmul[wgmma]": 3 * L if bf16 and rows > FMA_MAX_M else 0})
    return out


class RouteLog:
    """Every ``gating_dispatch`` call's routing (experts, probabilities of
    ``moe.route`` on the same router input) while installed."""

    def __init__(self):
        from repro_torch.kernels import ops as kops
        from repro_torch.models import moe as moe_lib
        self.kops, self.moe, self.calls = kops, moe_lib, []

    def __enter__(self):
        self.orig = dispatch = self.kops.gating_dispatch
        route, calls = self.moe.route, self.calls

        def rec(x, w, k, *args, **kw):
            r = route(x, w, k, kw.get("bias"))
            calls.append((r.experts.cpu(), r.probs.cpu()))
            return dispatch(x, w, k, *args, **kw)

        self.kops.gating_dispatch = rec
        return self

    def __exit__(self, *exc):
        self.kops.gating_dispatch = self.orig


def p11_serve(torch, cfg, params, prompts, max_seq, *, steps, forced=None,
              routes=None, before_step=None, keep=None, extras=None):
    """``prefill`` (with the stub inputs ``extras``) then ``steps`` greedy
    ``decode_step``s under whatever is installed; with ``forced`` (steps,
    B) the decode steps take those tokens instead (teacher forcing).  Returns (each pass's logits on the
    host in f32, the tokens fed to the steps and the last argmax, each
    decode step's host time in ms between two synchronizes, each pass's
    routing when ``routes``).  ``before_step(s)`` is called before step
    s; ``keep`` (a list) receives a host copy of the prefilled cache."""
    from repro_torch.models.transformer import decode_step, prefill
    B, T = prompts.shape
    logits, toks, ms, per_pass = [], [], [], []
    with torch.no_grad():
        n0 = len(routes.calls) if routes is not None else 0
        lg, cache = prefill(params, cfg, prompts, max_seq=max_seq, **(extras or {}))
        if keep is not None:
            keep.append([{k: t.to("cpu", copy=True) for k, t in e.items()}
                         for e in cache])
        logits.append(lg)
        if routes is not None:
            per_pass.append(routes.calls[n0:])
        tok = lg.argmax(-1)
        for s in range(steps):
            if forced is not None:
                tok = forced[s].to(prompts.device)
            toks.append(tok)
            pos = torch.full((B,), T + s, dtype=torch.int32, device=prompts.device)
            n0 = len(routes.calls) if routes is not None else 0
            if before_step is not None:
                before_step(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = decode_step(params, cfg, tok, cache, pos)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg)
            if routes is not None:
                per_pass.append(routes.calls[n0:])
            tok = lg.argmax(-1)
        toks.append(tok)
    routes_cpu = [[(e.cpu(), p.cpu()) for e, p in calls] for calls in per_pass]
    return ([lg.float().cpu() for lg in logits], torch.stack(toks).cpu(), ms,
            routes_cpu)


def p11_check_bf16(torch, label, logits, want, routes, want_routes):
    """bf16 prefill logits (the last token of each row) against one
    process's on the same prompts, routing first: a row any of whose
    prompt tokens routes otherwise in some layer must sit at a near-tie
    there in both paths (margin < 1e-2) and is not held further (its
    cache differs from there on; no cap on such rows, as
    ``check_bf16_logits(deep=True)``); every other row's logits are
    within 5% of their range."""
    B = want[0].shape[0]
    flipped = {}
    worst = 0.0
    for s, (g, w, rg, rw) in enumerate(zip(logits, want, routes, want_routes,
                                           strict=True)):
        require(bool(torch.isfinite(g).all()), f"{label} pass {s}: non-finite logits")
        for l, ((ge, gp), (we, wp)) in enumerate(zip(rg, rw, strict=True)):
            K = we.shape[1]
            diff = (ge.sort(-1).values != we.sort(-1).values).any(-1)
            margin = torch.minimum(*[p.sort(-1, descending=True).values[:, K - 1]
                                     - p.sort(-1, descending=True).values[:, K]
                                     for p in (gp, wp)])
            per_row = we.shape[0] // B          # T tokens a row at prefill
            for tok in diff.nonzero().flatten().tolist():
                row = tok // per_row
                if row not in flipped:
                    require(float(margin[tok]) < 1e-2, f"{label} pass {s} layer {l}: "
                            f"row {row} routed differently away from a near-tie "
                            f"(margin {float(margin[tok]):.2e})")
                    flipped[row] = (s, l, float(margin[tok]))
        scale = float(w.abs().max())
        for row in range(B):
            if row not in flipped:
                rel = float((g[row] - w[row]).abs().max()) / scale
                require(rel < 5e-2, f"{label} pass {s}: logits of row {row} differ "
                        f"by {rel:.3e} of the range with the same routing")
                worst = max(worst, rel)
    return (f"prefill logits within {worst:.3e} of the range on the "
            f"{B - len(flipped)} rows routed alike; near-tie flips "
            + (", ".join(f"row {r} layer {l} margin {m:.2e}"
                         for r, (_, l, m) in sorted(flipped.items())) or "none"))


def p11_one_process(torch, which, dev, out_dir):
    """11(which) in one process: f32 at 2 layers, then bf16 at 4, each
    prefill + greedy decode steps with the routing recorded (the experts
    as one m2n shard of 8: the kernel path), saved under ``out_dir`` for
    the ranks, then the same steps again without the record, timed.
    Returns {dtype: (ms per step, peak GB)}."""
    import contextlib

    from repro_torch.core.m2n import use_m2n
    from repro_torch.models.transformer import init_params
    P, R = P11[which], P11_RUN
    out = {}
    for dt, L in ((torch.float32, R["f32_layers"]), (torch.bfloat16, R["bf16_layers"])):
        cfg = p11_cfg(which, L)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, R["seed"], dt, device=dev)
        prompts = p11_prompts(torch, which, cfg, dev)
        moe = use_m2n(1) if P["m2n"] else contextlib.nullcontext()
        kept = []
        with moe:
            with RouteLog() as routes:
                logits, toks, _, per_pass = p11_serve(
                    torch, cfg, params, prompts, P["max_seq"], steps=R["steps"],
                    routes=routes, keep=kept)
            ms = p11_serve(torch, cfg, params, prompts, P["max_seq"],
                           steps=R["steps"])[2]
        out[str(dt)] = (statistics.median(ms[1:]), torch.cuda.max_memory_allocated() / 1e9)
        torch.save({"logits": logits, "tokens": toks, "routes": per_pass,
                    "cache": kept[0]},
                   out_dir / f"p11{which}-{str(dt).split('.')[-1]}.pt")
        del params
        torch.cuda.empty_cache()
    return out


def p11_child(torch, which, out_dir):
    """One rank of 11(which): its blocks of the ``init_params`` draw (each
    leaf cut to them as it is drawn: ``rank_block_place``) under
    ``ModelParallel`` (and ``use_m2n`` over "model" for (a)).  f32:
    prefill + greedy decode, the tokens equal to one process's and the
    logits within 5e-4 of their range.  bf16: the same steps fed one
    process's tokens, the prefill's logits held routing-first
    (``p11_check_bf16``) and one decode step from one process's prefilled
    cache (the rank's blocks of it) by phase 3's rule
    (``check_bf16_logits``); then greedy steps timed alone, and the
    collectives of one decode step (recorded in the checked run) replayed
    alone on the host clock.  Every run's launch counts set to 0 just
    before and read just after, held to ``p11_predicted``.  Prints one
    JSON line."""
    import contextlib

    import torch.distributed as dist

    from repro_torch.core.m2n import use_m2n
    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import ModelParallel
    from repro_torch.models.transformer import decode_step, init_params
    from repro_torch.training.optimizer import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P, R = P11[which], P11_RUN
    tr = MultiControllerTransport(device="cuda")
    mesh = make_mesh(P["grid"], ("data", "model"), device=tr.device)
    dev, rank = tr.device, tr.process_index
    res = {"rank": rank, "device": str(dev), "backend": tr.backend}
    mesh_all_reduce = mesh.all_reduce

    def run(cfg, params, prompts, L, label, **kw):
        moe = (use_m2n(mesh=mesh, expert_axis="model") if P["m2n"]
               else contextlib.nullcontext())
        dist.barrier()
        reset_launch_counts()
        with ModelParallel(mesh).install(), moe:
            got = p11_serve(torch, cfg, params, prompts, P["max_seq"],
                            steps=R["steps"], **kw)
        launches = {k: v for k, v in launch_counts().items() if v}
        bf16 = label.startswith("bfloat16")
        want = {k: v for k, v in p11_predicted(which, L, bf16).items() if v}
        require(launches == want, f"phase 11({which}) {label} rank {rank}: "
                f"launches {launches}, predicted {want}")
        return got, launches

    for dt, L in ((torch.float32, R["f32_layers"]), (torch.bfloat16, R["bf16_layers"])):
        name = str(dt).split(".")[-1]
        cfg = p11_cfg(which, L)
        params = init_params(cfg, R["seed"], dt, device=dev,
                             place=rank_block_place(cfg, mesh))
        torch.cuda.reset_peak_memory_stats()
        ref = torch.load(Path(out_dir) / f"p11{which}-{name}.pt")
        prompts = p11_prompts(torch, which, cfg, dev)
        r = {"params_gb": sum(p.numel() * p.element_size()
                              for p in leaves(params)) / 1e9}
        if dt == torch.float32:
            (logits, toks, ms, _), r["launches"] = run(cfg, params, prompts, L, name)
            require(torch.equal(toks, ref["tokens"]),
                    f"phase 11({which}) f32 rank {rank}: greedy tokens differ from "
                    f"one process's")
            worst = max(float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(logits, ref["logits"], strict=True))
            require(worst <= 5e-4, f"phase 11({which}) f32 rank {rank}: logits off "
                    f"by {worst:.3e} of their range")
            r.update(logits_rel=worst, ms=ms)
        else:
            step_calls, cur = [], [-1]

            def recording(t, axes, op="sum"):
                if cur[0] == R["steps"] - 1:        # the last decode step's
                    step_calls.append((tuple(t.shape), t.dtype, axes, op))
                return mesh_all_reduce(t, axes, op)

            mesh.all_reduce = recording
            try:
                with RouteLog() as routes:
                    (logits, _, _, per_pass), r["launches"] = run(
                        cfg, params, prompts, L, name, forced=ref["tokens"][:-1],
                        routes=routes, before_step=lambda s: cur.__setitem__(0, s))
            finally:
                del mesh.all_reduce
            line = p11_check_bf16(torch, f"phase 11({which}) bf16 rank {rank} "
                                  f"prefill", logits[:1], ref["logits"][:1],
                                  per_pass[:1], ref["routes"][:1])
            # phase 3's rule: one decode step from one process's prefilled
            # cache (this rank's blocks of it), routing first
            blocks = sharding.shard_cache(ref["cache"], mesh, R["batch"])
            blocks = [{k: t.to(dev) for k, t in e.items()} for e in blocks]
            pos = torch.full((R["batch"],), P["prompt_len"], dtype=torch.int32,
                             device=dev)
            moe = (use_m2n(mesh=mesh, expert_axis="model") if P["m2n"]
                   else contextlib.nullcontext())
            with torch.no_grad(), ModelParallel(mesh).install(), moe, \
                    RouteLog() as step_routes:
                got, _ = decode_step(params, cfg, ref["tokens"][0].to(dev), blocks, pos)
            line += "; one step from one process's cache: " + check_bf16_logits(
                torch, f"phase 11({which}) bf16 rank {rank} step", ref["logits"][1],
                got.float().cpu(), ref["routes"][1],
                [(e.cpu(), p.cpu()) for e, p in step_routes.calls], L)
            agree = float((torch.stack([lg.argmax(-1) for lg in logits[1:]])
                           == ref["tokens"][1:]).float().mean())
            (_, _, ms, _), timed = run(cfg, params, prompts, L, name + " timed")
            bufs = [torch.zeros(shape, dtype=dtp, device=dev)
                    for shape, dtp, _, _ in step_calls]
            reps = []
            for _ in range(5):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b, (_, _, axes, op) in zip(bufs, step_calls):
                    mesh_all_reduce(b, axes, op)
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) * 1e3)
            r.update(check=line, agree=agree, ms=ms, coll_ms=statistics.median(reps),
                     n_coll=len(step_calls),
                     coll_bytes=sum(b.numel() * b.element_size() for b in bufs))
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res[name] = r
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    print("phase11 " + json.dumps(res), flush=True)


def partial_attention_row(torch, dev):
    """The partial branch of ``decode_attention`` at 11(b)'s shape (8 rows,
    24 query heads gathered, every one of 8 kv heads on one rank's 64
    slots, hd 128): against its plain version in bf16 (2e-2) and f32
    (1e-5) on a block partly valid, one fully valid and one with no valid
    slot (out 0, lse -inf); timed beside the plain version and SDPA over
    the same block.  Returns the kernels line's row."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import decode_attention_partial as plain
    gen = torch.Generator(device=dev).manual_seed(11)
    B, H, Hkv, hd, Wl = P11_RUN["batch"], 24, 8, 128, 64
    pos = torch.full((B,), 100, dtype=torch.int32, device=dev)
    blocks = {"part": torch.arange(64, 128, dtype=torch.int32, device=dev),
              "full": torch.arange(0, 64, dtype=torch.int32, device=dev),
              "empty": torch.full((Wl,), -1, dtype=torch.int32, device=dev)}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        q = torch.randn(B, H, hd, device=dev, generator=gen).to(dt)
        k = torch.randn(B, Wl, Hkv, hd, device=dev, generator=gen).to(dt)
        v = torch.randn(B, Wl, Hkv, hd, device=dev, generator=gen).to(dt)
        for label, cp in blocks.items():
            cpos = cp.repeat(B, 1).contiguous()
            out, lse = kops.decode_attention(q, k, v, cpos, pos, partial=True)
            p_out, p_lse = plain(q, k, v, cpos, pos)
            torch.cuda.synchronize()
            require(out.dtype == lse.dtype == torch.float32, "partial: not f32")
            if label == "empty":
                require(bool(torch.isneginf(lse).all()) and float(out.abs().max()) == 0,
                        "partial: a block with no valid slot")
                continue
            check_close(torch, f"decode_attention[partial] {dt} {label}", out, p_out,
                        tol, tol)
            check_close(torch, f"decode_attention[partial] {dt} {label} lse", lse,
                        p_lse, tol, tol)
    # timed on the bf16 partly valid block (the one a middle rank holds)
    q = torch.randn(B, H, hd, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, Wl, Hkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, Wl, Hkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    cpos = blocks["part"].repeat(B, 1).contiguous()
    args = (q, k, v, cpos, pos)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    ok = (cpos >= 0) & (cpos <= pos[:, None])
    valid = int(ok.sum())
    got, want = kops.decode_attention(*args, partial=True), plain(*args)
    err = max(max_err(torch, got[0], want[0]), max_err(torch, got[1], want[1]))
    nbytes = (q.numel() * 2 + valid * Hkv * hd * 2 * 2 + cpos.numel() * 4 + B * 4
              + B * H * hd * 4 + B * H * 4)
    r = dict(err=err, ms=time_ms(torch, lambda: kops.decode_attention(*args, partial=True),
                                 flush=flush),
             plain_ms=time_ms(torch, lambda: plain(*args), flush=flush),
             library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                 q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                 attn_mask=ok[:, None, None, :], enable_gqa=True), flush=flush),
             bound=bound_ms(nbytes, 4 * valid * H * hd, "bfloat16"),
             replaces="src/repro/kernels/decode_attention.py:85",
             shape=f"q {tuple(q.shape)} block {tuple(k.shape)} of a 192-slot ring, "
                   f"{valid // B} valid slots a row")
    print(f"decode_attention[partial] {r['shape']}: {r['ms']:.4f} ms, sdpa "
          f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound'][0]:.5f} ms, max |err| {err:.3e}; f32 within 1e-5 and bf16 "
          f"within 2e-2 of the plain version on a partly valid, a full and an "
          f"empty block")
    return r


def phase_serving_grid(torch, dev):
    """Phase 11: (a) and (b), each first in one process (saved for the
    ranks, memory freed after), then on its grid of processes on the one
    card over gloo; prints ms per decode step beside one process's, the
    model-axis collectives' share, params and peak per rank.  Returns the
    partial branch's kernels row, its launches those of 11(b)'s bf16
    run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row = partial_attention_row(torch, dev)
    out_dir = ROOT / "build" / "phase11"
    out_dir.mkdir(parents=True, exist_ok=True)
    med = lambda xs: statistics.median(xs[1:])
    for which in ("a", "b"):
        P = P11[which]
        t0 = time.perf_counter()
        one = p11_one_process(torch, which, dev, out_dir)
        n = P["grid"][0] * P["grid"][1]
        out = run_ranks([str(ROOT / "chip_smoke.py"), "--phase11", which,
                         str(out_dir)], n, timeout=P11_TIMEOUT)
        ranks = []
        for rank, (rc, text) in enumerate(out):
            require(rc == 0, f"phase 11({which}): rank {rank} exited {rc}:\n"
                    f"{text[-4000:]}")
            lines = [ln for ln in text.splitlines() if ln.startswith("phase11 ")]
            require(len(lines) == 1, f"phase 11({which}): rank {rank} printed no "
                    f"result:\n{text[-4000:]}")
            ranks.append(json.loads(lines[0][len("phase11 "):]))
        ranks.sort(key=lambda g: g["rank"])
        ms1, peak1 = one["torch.bfloat16"]
        for g in ranks:
            b = g["bfloat16"]
            step = med(b["ms"])
            print(f"phase 11({which}) rank {g['rank']} on {g['device']} over "
                  f"{g['backend']}: bf16 {step:.2f} ms per decode step (median of "
                  f"steps 2-{P11_RUN['steps']}) vs {ms1:.2f} in one process; "
                  f"model-axis collectives of one step ({b['n_coll']} all_reduces, "
                  f"{b['coll_bytes'] / 1e6:.2f} MB) replayed alone "
                  f"{b['coll_ms']:.2f} ms ({b['coll_ms'] / step:.3f} of the step, "
                  f"host clock); params "
                  f"{b['params_gb']:.2f} GB, peak {b['peak_gb']:.2f} GB (one process "
                  f"{peak1:.2f}); launches {b['launches']}; greedy agreement "
                  f"{b['agree']:.3f}; f32 tokens exact, logits within "
                  f"{g['float32']['logits_rel']:.2e} of their range, f32 "
                  f"{med(g['float32']['ms']):.2f} ms/step vs "
                  f"{one['torch.float32'][0]:.2f}; bf16: {b['check']}")
        if which == "b":
            row["launches"] = ranks[0]["bfloat16"]["launches"]["decode_attention[partial]"]
            row["rank_launches"] = [g["bfloat16"]["launches"]["decode_attention[partial]"]
                                    for g in ranks]
        print(f"phase 11({which}) {P['arch']} at published width on a "
              f"{tuple(P['grid'])} (data, model) grid: {P11_RUN['batch']} requests "
              f"of {P['prompt_len']}-token prompts, {P11_RUN['steps']} decode steps, "
              f"ring {P['max_seq']}; {time.perf_counter() - t0:.1f} s with the "
              f"one-process runs and the ranks' start")
    return row


# ---------------------------------------------------------------------------
# phase 12: every layer kind on a rank's shards
# ---------------------------------------------------------------------------

# (a) training on a (1, 2) grid, f32, TF32 off, batch 4 x seq 128, 3
# steps, published widths cut in depth only: recurrentgemma-2b one period
# (rglru, rglru, local; 26 layers and the remainder cut), mamba2-1.3b 2
# of its 48 layers, whisper-large-v3 1 encoder + 1 decoder layer (of 32 +
# 32), llama-3.2-vision-90b its cross layer alone (the period's 4 attn
# layers and the other 19 periods cut): its 128,256 x 8192 embedding and
# head make ~48 GB of state, ~24 GB a rank, so it runs last
P12_TRAIN = {"recurrentgemma-2b": dict(n_layers=3),
             "mamba2-1.3b": dict(n_layers=2),
             "whisper-large-v3": dict(n_layers=1, encoder_layers=1),
             "llama-3.2-vision-90b": dict(n_layers=1, block_pattern=("cross",))}
P12_TRAIN_RUN = dict(grid=(1, 2), batch=4, seq=128, steps=3, lr=1e-3, seed=0)
# (b) serving, 8 requests, 8 greedy steps (each a few hundred ms on a
# grid: 96-194 collectives through gloo): f32 at one period (whisper's
# encoder cut to 1 layer there), then bf16 at ``layers`` (None: whole).
# recurrentgemma-2b on (1, 4): the RG-LRU width and 10 query heads (2.5 a
# rank, cut mid-head) over 4, one kv head, so the local layers'
# 2048-slot rings split 4 ways (1600-token prompts reach every rank's
# block); mamba2-1.3b, whisper-large-v3 (encoder tensor-parallel, 20 kv
# heads and the cross K / V by heads) and llama-3.2-vision-90b at one
# period (5 of 100 layers) on (1, 2)
P12_SERVE = {
    "recurrentgemma-2b": dict(grid=(1, 4), layers=None, period=3, prompt_len=1600,
                              max_seq=2048, steps=8),
    "mamba2-1.3b": dict(grid=(1, 2), layers=None, period=1, prompt_len=16,
                        max_seq=64, steps=8),
    "whisper-large-v3": dict(grid=(1, 2), layers=None, period=1, prompt_len=16,
                             max_seq=64, steps=8),
    "llama-3.2-vision-90b": dict(grid=(1, 2), layers=5, period=5, prompt_len=16,
                                 max_seq=64, steps=8),
}
P12_BATCH = 8
P12_TIMEOUT = 300          # seconds for all ranks of one sub-phase


def p12_cfg(name, n_layers=None, encoder_layers=None, block_pattern=None):
    """``name``'s published config cut in depth (None: whole)."""
    from repro_torch.config import get_config
    cfg = get_config(name)
    if block_pattern is not None:
        cfg = dataclasses.replace(cfg, block_pattern=block_pattern)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers, remainder_pattern=())
    if encoder_layers is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=encoder_layers))
    return cfg


def p12_train_setup(torch, name, dev):
    """(config, AdamW config, the steps' batches, the stub inputs) of 12(a)."""
    from repro_torch.models.stubs import extra_inputs
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    R = P12_TRAIN_RUN
    cfg = p12_cfg(name, **P12_TRAIN[name])
    opt = AdamWConfig(lr=R["lr"], warmup_steps=2, total_steps=R["steps"])
    batches = [torch.from_numpy(b).to(dev) for b in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=R["seq"] + 1, batch=R["batch"],
        seed=R["seed"])).batches(R["steps"])]
    return cfg, opt, batches, extra_inputs(cfg, R["batch"], dtype=torch.float32,
                                           device=dev)


def p12_train_steps(torch, cfg, opt, batches, extras, params, mesh=None,
                    before=None, keep=None, keep_leaf=None):
    """A train step of ``params`` (the rank's blocks on ``mesh``, else
    whole) per batch, each timed on the host clock between two
    synchronizes: (metrics, ms).  ``before(s)`` runs before step s;
    ``keep`` (a list) receives ``keep_leaf(i, g)`` (default: a copy on the
    host) of step 0's gradient g of each leaf i, taken before the
    update."""
    from repro_torch.training import loop
    from repro_torch.training.optimizer import init_opt_state, leaves
    for p in leaves(params):
        p.requires_grad_(True)
    state = init_opt_state(params)
    step = loop.make_train_step(cfg, opt, remat="none", mesh=mesh,
                                extras_keys=tuple(extras))
    update = loop.adamw_update
    keep_leaf = keep_leaf or (lambda i, g: g.to("cpu", copy=True))

    def keep_grads(opt_cfg, ps, g, st, **kw):
        if keep is not None and not keep:
            keep.extend(keep_leaf(i, t.detach()) for i, t in enumerate(g))
        return update(opt_cfg, ps, g, st, **kw)

    loop.adamw_update = keep_grads
    metrics, ms = [], []
    try:
        for s, toks in enumerate(batches):
            if before is not None:
                before(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, toks, *extras.values())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        loop.adamw_update = update
    return metrics, ms


def p12_train_one(torch, name, dev):
    """12(a)'s ``name`` in one process: (metrics, ms per step, peak GB)."""
    cfg, opt, batches, extras = p12_train_setup(torch, name, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = registry_params(torch, cfg, torch.float32, dev)
    metrics, ms = p12_train_steps(torch, cfg, opt, batches, extras, params)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return metrics, ms, peak


def p12_train_child(torch, out_dir):
    """One rank of 12(a): for each model, its blocks of the
    ``registry_params`` draw (each leaf cut as it is drawn), 3 steps on
    the (1, 2) grid with every model-axis collective timed (host clock),
    the launches counted; step 0's gradients and the params after step 0
    kept on the host.  Then, one rank at a time (the other at a barrier),
    one process's step 0 on the whole params, keeping the rank's blocks
    of its gradients: against the rank's (1e-5 of each leaf's max |g|);
    the update of those blocks from the rank's initial blocks (drawn
    again from the seed; leaf by leaf, its decay mask, one process's
    norm) against the rank's blocks of one process's params after the
    step (1e-5 of each
    leaf's range: 8(a)'s rule for the update of the same gradients); the
    rank's own params after step 0 against them, each element within what
    its gradient's gap allows through AdamW's first step (below), with
    8(a)'s count of elements past 1e-5 of their leaf's range and the
    widest gap in units of the step's lr printed.  Prints one JSON line.

    AdamW's first step moves an element by lr * g' / (|g'| + eps) (g' the
    clipped gradient, bias correction cancelling) plus the decay, which
    both paths share; x / (|x| + eps) moves by at most |dx| / eps and
    never by more than 2, so two gradients dg apart give params at most
    lr * min(2, s * dg / eps) apart (s the clip scale), plus rounding:
    1e-5 of the leaf's range (8(a)'s) and 1e-6 of the element (a few f32
    ulps: RG-LRU's ``lam`` sits at 0.5 with a range of 2 lr).  Where a gradient element sits near eps
    (a 128,256-token head at batch 4 x 128) the gap is a good part of lr
    while the gradients agree to 1e-4 of their max; 8(a)'s count cannot
    tell that from a wrong update, this bound can."""
    import torch.distributed as dist

    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import (OptState, adamw_update, cosine_lr,
                                                decay_mask, leaves,
                                                named_leaves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = MultiControllerTransport(device="cuda")
    rank, n = tr.process_index, tr.process_count
    mesh = make_mesh(P12_TRAIN_RUN["grid"], ("data", "model"), device=tr.device)
    mesh_all_reduce = mesh.all_reduce
    host = lambda t: t.detach().to("cpu", copy=True)
    res = {"rank": rank, "device": str(tr.device), "backend": tr.backend}
    for name in P12_TRAIN:
        t_model = time.perf_counter()
        cfg, opt, batches, extras = p12_train_setup(torch, name, tr.device)
        params = registry_params(torch, cfg, torch.float32, tr.device,
                                 place=rank_block_place(cfg, mesh))
        flat = [sp for _, sp in sharding.named_specs(sharding.param_specs(
            cfg, init_params(cfg, device="meta"), mesh))]
        torch.cuda.reset_peak_memory_stats()
        names = [k for k, _ in named_leaves(params)]
        mask = decay_mask(params, cfg)
        state_gb = 4 * sum(p.numel() * p.element_size() for p in leaves(params)) / 1e9
        coll_ms, grads, after0 = [], [], []

        def timed_all_reduce(t, axes, op="sum"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh_all_reduce(t, axes, op)
            torch.cuda.synchronize()
            coll_ms[-1][0] += (time.perf_counter() - t0) * 1e3
            coll_ms[-1][1] += 1
            return t

        def before(s):
            coll_ms.append([0.0, 0])
            if s == 1:                          # the params after step 0
                after0.extend(host(p) for p in leaves(params))

        mesh.all_reduce = timed_all_reduce
        dist.barrier()
        reset_launch_counts()
        try:
            metrics, ms = p12_train_steps(torch, cfg, opt, batches, extras, params,
                                          mesh=mesh, before=before, keep=grads)
        finally:
            del mesh.all_reduce
        launches = {k: v for k, v in launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 1e9
        del params
        torch.cuda.empty_cache()
        lr = float(cosine_lr(opt, 1))
        out = {}
        for r in range(n):
            dist.barrier()
            if r != rank:
                continue
            one = registry_params(torch, cfg, torch.float32, tr.device)
            blocks = []
            m1, _ = p12_train_steps(
                torch, cfg, opt, batches[:1], extras, one, keep=blocks,
                keep_leaf=lambda i, g: sharding.local_shard(g, flat[i], mesh).clone())
            # the rank's initial blocks, drawn again from the seed (the same
            # values, no copy kept through the steps)
            start = leaves(registry_params(torch, cfg, torch.float32, tr.device,
                                           place=rank_block_place(cfg, mesh)))
            gnorm = torch.tensor(m1[0]["grad_norm"], device=tr.device)
            clip = min(1.0, opt.grad_clip / (m1[0]["grad_norm"] + 1e-9))
            g_worst = g0_worst = u_worst = s_worst = b_worst = (0.0, "")
            n_off = n_all = n_past = 0
            for i, (k, b, p1, sp) in enumerate(zip(names, blocks, leaves(one), flat,
                                                   strict=True)):
                dg = (grads[i].to(tr.device) - b).abs()
                e = float(dg.max()) / max(float(b.abs().max()), 1e-30)
                if b.ndim:
                    g_worst = max(g_worst, (e, k))
                else:
                    g0_worst = max(g0_worst, (e, k))
                want = sharding.local_shard(p1.detach(), sp, mesh)
                rng = float(want.max() - want.min()) or 1.0
                up = start[i]
                adamw_update(opt, [up], [b], OptState(
                    torch.zeros((), dtype=torch.int32), [torch.zeros_like(up)],
                    [torch.zeros_like(up)]), decay=[mask[i]], gnorm=gnorm)
                u_worst = max(u_worst, (float((up - want).abs().max()) / rng, k))
                d = (after0[i].to(tr.device) - want).abs()
                n_off += int((d > 1e-5 * rng).sum())
                n_all += d.numel()
                allowed = (lr * torch.clamp(clip * dg / opt.eps, max=2.0) + 1e-5 * rng
                           + 1e-6 * want.abs())
                n_past += int((d > allowed).sum())
                b_worst = max(b_worst, (float((d / allowed).max()), k))
                s_worst = max(s_worst, (float(d.max()) / lr, k))
            out = dict(grad_worst=g_worst, grad0_worst=g0_worst,
                       update_worst=u_worst, params_off=n_off, params_past=n_past,
                       params_bound=b_worst,
                       params_all=n_all, params_gap_lr=s_worst,
                       one_gnorm=m1[0]["grad_norm"])
            del one, blocks, start
            torch.cuda.empty_cache()
        dist.barrier()
        res[name] = dict(out, metrics=metrics, ms=ms, coll=coll_ms, peak_gb=peak,
                         state_gb=state_gb, launches=launches,
                         wall_s=time.perf_counter() - t_model)
        del grads, after0
    print("phase12a " + json.dumps(res), flush=True)


def p12_predicted(cfg, steps, grid=None):
    """Host launches of one rank's prefill and ``steps`` decode steps: one
    decode attention per self-attention layer and step (``attn``,
    ``local``, the self half of ``selfcross``), its partial branch where
    the model axis splits the ring's slots (kv heads that do not divide
    it); prefill and cross attention run the plain versions."""
    n = steps * sum(k in ("attn", "local", "selfcross") for k in cfg.layer_kinds)
    slots = grid is not None and cfg.n_kv_heads % grid[1] != 0
    return {"decode_attention": n, "decode_attention[partial]": n if slots else 0}


def p12_serve_setup(torch, name, dtype, dev, mesh=None):
    """(config, params, prompts, stub inputs) of 12(b)'s ``name`` in
    ``dtype``: f32 at one period, bf16 at the serving depth; with
    ``mesh``, the rank's blocks of the params (``rank_block_place``)."""
    from repro_torch.models.stubs import extra_inputs
    P = P12_SERVE[name]
    if dtype == torch.float32:
        cfg = p12_cfg(name, n_layers=P["period"],
                      encoder_layers=1 if name == "whisper-large-v3" else None)
    else:
        cfg = p12_cfg(name, n_layers=P["layers"])
    gen = torch.Generator(device="cpu").manual_seed(12)
    prompts = torch.randint(2, cfg.vocab, (P12_BATCH, P["prompt_len"]),
                            generator=gen).to(dev)
    place = rank_block_place(cfg, mesh) if mesh is not None else None
    return (cfg, registry_params(torch, cfg, dtype, dev, place=place), prompts,
            extra_inputs(cfg, P12_BATCH, dtype=dtype, device=dev))


def p12_serve_one(torch, name, dev, out_dir):
    """12(b)'s ``name`` in one process, f32 then bf16: prefill + greedy
    decode steps (launches counted), saved under ``out_dir`` with the
    bf16 prefilled cache, then the same steps again, timed.  Returns
    {dtype: (ms per step, peak GB, launches)}."""
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    P, out = P12_SERVE[name], {}
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.bfloat16):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, prompts, extras = p12_serve_setup(torch, name, dt, dev)
        kept = []
        reset_launch_counts()
        logits, toks, _, _ = p11_serve(torch, cfg, params, prompts, P["max_seq"],
                                       steps=P["steps"], keep=kept, extras=extras)
        launches = {k: v for k, v in launch_counts().items() if v}
        want = {k: v for k, v in p12_predicted(cfg, P["steps"]).items() if v}
        require(launches == want, f"phase 12(b) {name} {dt} one process: launches "
                f"{launches}, predicted {want}")
        ms = p11_serve(torch, cfg, params, prompts, P["max_seq"], steps=P["steps"],
                       extras=extras)[2]
        out[str(dt)] = (statistics.median(ms[1:]),
                        torch.cuda.max_memory_allocated() / 1e9, launches)
        torch.save({"logits": logits, "tokens": toks,
                    "cache": kept[0] if dt == torch.bfloat16 else None},
                   out_dir / f"p12-{name}-{str(dt).split('.')[-1]}.pt")
        del params, kept
        torch.cuda.empty_cache()
    print(f"phase 12(b) {name} one process (f32 and bf16, each served twice): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def p12_serve_child(torch, grid_key, out_dir):
    """One rank of 12(b) for the models served on ``grid_key`` ("1x4" or
    "1x2"): its blocks of the ``registry_params`` draw (each leaf cut as
    it is drawn) under ``ModelParallel``.  f32 (one period): prefill +
    greedy decode, the tokens equal to one process's and the logits within
    5e-4 of their range.  bf16: the steps fed one process's tokens (each
    timed), one decode step from one process's prefilled cache (the rank's
    blocks of it) held by phase 11's rule (``check_bf16_logits``: 5% of
    the range; no routing in these models), the prefill's logits beside
    one process's printed (16 tokens through mamba2's 48 bf16 layers part
    by ~5% of the range: each model-axis sum adds a bf16 rounding the one
    process does not have), and the collectives of one decode step
    replayed alone on the host clock.  Every run's launches set to 0 just
    before and read just after, held to ``p12_predicted``.  Prints one
    JSON line."""
    import torch.distributed as dist

    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import ModelParallel
    from repro_torch.models.transformer import decode_step
    from repro_torch.training.optimizer import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = [k for k, P in P12_SERVE.items() if "x".join(map(str, P["grid"])) == grid_key]
    grid = P12_SERVE[names[0]]["grid"]
    tr = MultiControllerTransport(device="cuda")
    mesh = make_mesh(grid, ("data", "model"), device=tr.device)
    dev, rank = tr.device, tr.process_index
    res = {"rank": rank, "device": str(dev), "backend": tr.backend}
    mesh_all_reduce = mesh.all_reduce
    for name in names:
        P = P12_SERVE[name]

        def run(cfg, params, prompts, extras, label, **kw):
            dist.barrier()
            reset_launch_counts()
            with ModelParallel(mesh).install():
                got = p11_serve(torch, cfg, params, prompts, P["max_seq"],
                                steps=P["steps"], extras=extras, **kw)
            launches = {k: v for k, v in launch_counts().items() if v}
            want = {k: v for k, v in p12_predicted(cfg, P["steps"], grid).items() if v}
            require(launches == want, f"phase 12(b) {name} {label} rank {rank}: "
                    f"launches {launches}, predicted {want}")
            return got, launches

        for dt in (torch.float32, torch.bfloat16):
            label = str(dt).split(".")[-1]
            t_model = time.perf_counter()
            cfg, params, prompts, extras = p12_serve_setup(torch, name, dt, dev, mesh)
            torch.cuda.reset_peak_memory_stats()
            ref = torch.load(Path(out_dir) / f"p12-{name}-{label}.pt")
            r = {"params_gb": sum(p.numel() * p.element_size()
                                  for p in leaves(params)) / 1e9}
            if dt == torch.float32:
                (logits, toks, ms, _), r["launches"] = run(cfg, params, prompts,
                                                           extras, label)
                require(torch.equal(toks, ref["tokens"]),
                        f"phase 12(b) {name} f32 rank {rank}: greedy tokens differ "
                        f"from one process's")
                worst = max(float((g - w).abs().max() / w.abs().max())
                            for g, w in zip(logits, ref["logits"], strict=True))
                require(worst <= 5e-4, f"phase 12(b) {name} f32 rank {rank}: logits "
                        f"off by {worst:.3e} of their range")
                r.update(logits_rel=worst, ms=ms)
            else:
                step_calls, cur = [], [-1]

                def recording(t, axes, op="sum"):
                    if cur[0] == P["steps"] - 1:        # the last decode step's
                        step_calls.append((tuple(t.shape), t.dtype, axes, op))
                    return mesh_all_reduce(t, axes, op)

                mesh.all_reduce = recording
                try:
                    (logits, _, ms, _), r["launches"] = run(
                        cfg, params, prompts, extras, label,
                        forced=ref["tokens"][:-1],
                        before_step=lambda s: cur.__setitem__(0, s))
                finally:
                    del mesh.all_reduce
                g0, w0 = logits[0], ref["logits"][0]
                line = (f"prefill logits within "
                        f"{float((g0 - w0).abs().max() / w0.abs().max()):.3e} of the "
                        f"range, argmax agreement "
                        f"{float((g0.argmax(-1) == w0.argmax(-1)).float().mean()):.2f}")
                blocks = sharding.shard_cache(ref["cache"], mesh, P12_BATCH)
                blocks = [{k: t.to(dev) for k, t in e.items()} for e in blocks]
                pos = torch.full((P12_BATCH,), P["prompt_len"], dtype=torch.int32,
                                 device=dev)
                with torch.no_grad(), ModelParallel(mesh).install():
                    got, _ = decode_step(params, cfg, ref["tokens"][0].to(dev),
                                         blocks, pos)
                line += "; one step from one process's cache " + check_bf16_logits(
                    torch, f"phase 12(b) {name} bf16 rank {rank} step",
                    ref["logits"][1], got.float().cpu(), [], [], cfg.n_layers)
                del blocks
                agree = float((torch.stack([lg.argmax(-1) for lg in logits[1:]])
                               == ref["tokens"][1:]).float().mean())
                bufs = [torch.zeros(shape, dtype=dtp, device=dev)
                        for shape, dtp, _, _ in step_calls]
                reps = []
                for _ in range(3):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for b, (_, _, axes, op) in zip(bufs, step_calls):
                        mesh_all_reduce(b, axes, op)
                    torch.cuda.synchronize()
                    reps.append((time.perf_counter() - t0) * 1e3)
                r.update(check=line, agree=agree, ms=ms,
                         coll_ms=statistics.median(reps), n_coll=len(step_calls),
                         coll_bytes=sum(b.numel() * b.element_size() for b in bufs))
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            r["wall_s"] = time.perf_counter() - t_model
            res[f"{name}/{label}"] = r
            del params
            torch.cuda.empty_cache()
    dist.barrier()
    print("phase12b " + json.dumps(res), flush=True)


def partial_attention_row_hd256(torch, dev):
    """The partial branch of ``decode_attention`` at 12(b)'s recurrentgemma
    shape on one of 4 ranks: q (8, 10, 256) over a (8, 512, 1, 256) block
    of a 2048-slot ring that every row has wrapped (window 2048), held
    against its plain version (f32 1e-5, bf16 2e-2) on the block a middle
    rank holds and with one row of it empty (out 0, lse -inf); timed in
    bf16 beside the plain version and SDPA over the same block.  Returns
    the kernels line's shape entry."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import decode_attention_partial as plain
    gen = torch.Generator(device=dev).manual_seed(12)
    B, H, Hkv, hd, W, m = P12_BATCH, 10, 1, 256, 2048, 4
    Wl = W // m
    pos = torch.randint(W, 3 * W, (B,), generator=gen, device=dev).to(torch.int32)
    slots = torch.arange(Wl, 2 * Wl, device=dev)           # rank 1's block
    cpos = (pos[:, None] - (pos[:, None] - slots[None]) % W).to(torch.int32)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        q = torch.randn(B, H, hd, device=dev, generator=gen).to(dt)
        k = torch.randn(B, Wl, Hkv, hd, device=dev, generator=gen).to(dt)
        v = torch.randn(B, Wl, Hkv, hd, device=dev, generator=gen).to(dt)
        cp = cpos.clone()
        cp[0] = -1                                         # row 0: an empty block
        out, lse = kops.decode_attention(q, k, v, cp, pos, window=W, partial=True)
        p_out, p_lse = plain(q, k, v, cp, pos, window=W)
        torch.cuda.synchronize()
        require(out.dtype == lse.dtype == torch.float32, "partial hd 256: not f32")
        require(bool(torch.isneginf(lse[0]).all()) and float(out[0].abs().max()) == 0,
                "partial hd 256: a row with no valid slot")
        check_close(torch, f"decode_attention[partial] hd 256 {dt}", out, p_out,
                    tol, tol)
        check_close(torch, f"decode_attention[partial] hd 256 {dt} lse", lse[1:],
                    p_lse[1:], tol, tol)
    q = torch.randn(B, H, hd, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, Wl, Hkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, Wl, Hkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    args = (q, k, v, cpos, pos)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    ok = (cpos >= 0) & (cpos <= pos[:, None]) & (cpos > pos[:, None] - W)
    valid = int(ok.sum())
    got, want = kops.decode_attention(*args, window=W, partial=True), \
        plain(*args, window=W)
    err = max(max_err(torch, got[0], want[0]), max_err(torch, got[1], want[1]))
    nbytes = (q.numel() * 2 + valid * Hkv * hd * 2 * 2 + cpos.numel() * 4 + B * 4
              + B * H * hd * 4 + B * H * 4)
    r = dict(err=err,
             ms=time_ms(torch, lambda: kops.decode_attention(*args, window=W,
                                                             partial=True),
                        flush=flush),
             plain_ms=time_ms(torch, lambda: plain(*args, window=W), flush=flush),
             library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                 q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                 attn_mask=ok[:, None, None, :], enable_gqa=True), flush=flush),
             bound=bound_ms(nbytes, 4 * valid * H * hd, "bfloat16"),
             shape=f"q {tuple(q.shape)} block {tuple(k.shape)} of a wrapped "
                   f"{W}-slot ring, window {W}, {valid // B} valid slots a row")
    print(f"decode_attention[partial] {r['shape']}: {r['ms']:.4f} ms, sdpa "
          f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound'][0]:.5f} ms, max |err| {err:.3e}; f32 within 1e-5 and bf16 "
          f"within 2e-2 of the plain version, a row with no valid slot 0 and -inf")
    return r


def p12_ranks(torch, flag, arg, n, prefix):
    """Run ``chip_smoke.py flag arg DIR`` as ``n`` ranks; each rank's JSON
    line (``prefix``), in rank order."""
    out_dir = ROOT / "build" / "phase12"
    out = run_ranks([str(ROOT / "chip_smoke.py"), flag, arg, str(out_dir)], n,
                    timeout=P12_TIMEOUT)
    ranks = []
    for rank, (rc, text) in enumerate(out):
        require(rc == 0, f"phase 12 {arg}: rank {rank} exited {rc}:\n{text[-4000:]}")
        lines = [ln for ln in text.splitlines() if ln.startswith(prefix + " ")]
        require(len(lines) == 1, f"phase 12 {arg}: rank {rank} printed no result:\n"
                f"{text[-4000:]}")
        ranks.append(json.loads(lines[0][len(prefix) + 1:]))
    return sorted(ranks, key=lambda g: g["rank"])


def phase_every_kind(torch, dev):
    """Phase 12: (a) training and (b) serving of the four families on a
    rank's shards, each first in one process (memory freed before the
    ranks start), and (c) the partial branch at hd 256.  Returns the
    kernels line's partial-branch shape entry, with each recurrentgemma
    rank's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "build" / "phase12"
    out_dir.mkdir(parents=True, exist_ok=True)
    med = lambda xs: statistics.median(xs[1:])
    R = P12_TRAIN_RUN
    t0 = time.perf_counter()
    one = {name: p12_train_one(torch, name, dev) for name in P12_TRAIN}
    print(f"phase 12(a) one process: {time.perf_counter() - t0:.1f} s", flush=True)
    ranks = p12_ranks(torch, "--phase12", "a", R["grid"][0] * R["grid"][1],
                      "phase12a")
    for name, (ref, ref_ms, ref_peak) in one.items():
        for g in ranks:
            r = g[name]
            step = med(r["ms"])
            coll = [c[0] for c in r["coll"]]
            print(f"phase 12(a) {name} rank {g['rank']} on {g['device']} over "
                  f"{g['backend']}: {step:.2f} ms/step vs {med(ref_ms):.2f} in one "
                  f"process; {r['coll'][1][1]} model-axis all_reduces a step, "
                  f"{med(coll):.2f} ms ({med(coll) / step:.3f} of the step); "
                  f"{r['state_gb']:.2f} GB of params, grads and moments, peak "
                  f"{r['peak_gb']:.2f} GB (one process {ref_peak:.2f}); losses "
                  f"{[round(m['loss'], 6) for m in r['metrics']]} vs "
                  f"{[round(m['loss'], 6) for m in ref]}; worst gradient "
                  f"{r['grad_worst'][0]:.2e} of max |g| ({r['grad_worst'][1]})"
                  + (f", of the 0-d leaves {r['grad0_worst'][0]:.2e} "
                     f"({r['grad0_worst'][1]})" if r["grad0_worst"][1] else "")
                  + f"; the "
                  f"update of the same gradients {r['update_worst'][0]:.2e} of the "
                  f"range; step 0's own params: {r['params_past']} past the gap "
                  f"their gradients allow (at most {r['params_bound'][0]:.3f} of it, "
                  f"{r['params_bound'][1]}), {r['params_off']} of {r['params_all']} "
                  f"past 1e-5 of the range (8(a)'s count), widest gap "
                  f"{r['params_gap_lr'][0]:.2f} lr ({r['params_gap_lr'][1]}); "
                  f"{r['wall_s']:.1f} s on the rank")
            for s, (m, w) in enumerate(zip(r["metrics"], ref, strict=True)):
                require(abs(m["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]),
                        f"phase 12(a) {name} rank {g['rank']} step {s}: loss "
                        f"{m['loss']} vs {w['loss']} (one process)")
            require(abs(r["metrics"][0]["grad_norm"] - r["one_gnorm"])
                    <= 1e-5 * r["one_gnorm"], f"phase 12(a) {name} rank {g['rank']}: "
                    f"step 0's norm {r['metrics'][0]['grad_norm']} vs "
                    f"{r['one_gnorm']}")
            require(r["grad_worst"][0] <= 1e-4, f"phase 12(a) {name} rank "
                    f"{g['rank']}: gradient {r['grad_worst'][1]} off by "
                    f"{r['grad_worst'][0]:.2e} of its max |g|")
            # a 0-d leaf's gradient (llama-vision's tanh gates) is one sum
            # of B * T * d products of both signs (4.2 M at width 8192),
            # each rounded otherwise on the two paths; cancellation over so
            # many terms lifts the sum's relative rounding error about
            # sqrt(N)-fold, so it is held at 1e-2 of |g| where every other
            # leaf is held at 1e-4 of its max |g| (8(a)'s rule)
            require(r["grad0_worst"][0] <= 1e-2, f"phase 12(a) {name} rank "
                    f"{g['rank']}: gradient {r['grad0_worst'][1]} off by "
                    f"{r['grad0_worst'][0]:.2e} of |g|")
            require(r["update_worst"][0] <= 1e-5, f"phase 12(a) {name} rank "
                    f"{g['rank']}: the update of one process's gradients gives "
                    f"{r['update_worst'][1]} off by {r['update_worst'][0]:.2e} of "
                    f"its range")
            require(r["params_past"] == 0, f"phase 12(a) {name} rank {g['rank']}: "
                    f"{r['params_past']} elements of step 0's params past what their "
                    f"gradients' gap allows through AdamW's first step")
            require(not r["launches"], f"phase 12(a) {name}: the training path "
                    f"launched {r['launches']}")
    print(f"phase 12(a) f32, TF32 off, batch {R['batch']} x seq {R['seq']}, "
          f"{R['steps']} steps on a {R['grid']} grid: {time.perf_counter() - t0:.1f} s "
          f"with the one-process runs and the ranks' start")
    t0 = time.perf_counter()
    row = partial_attention_row_hd256(torch, dev)
    one = {name: p12_serve_one(torch, name, dev, out_dir) for name in P12_SERVE}
    for key in ("1x4", "1x2"):
        names = [k for k, P in P12_SERVE.items()
                 if "x".join(map(str, P["grid"])) == key]
        grid = P12_SERVE[names[0]]["grid"]
        ranks = p12_ranks(torch, "--phase12", key, grid[0] * grid[1], "phase12b")
        for name in names:
            P = P12_SERVE[name]
            ms1, peak1, l1 = one[name]["torch.bfloat16"]
            for g in ranks:
                b, f = g[f"{name}/bfloat16"], g[f"{name}/float32"]
                step = med(b["ms"])
                print(f"phase 12(b) {name} rank {g['rank']} on a {grid} grid over "
                      f"{g['backend']}: bf16 {step:.2f} ms per decode step (fed one "
                      f"process's tokens, median of steps 2-{P['steps']}) vs "
                      f"{ms1:.2f} in one process (greedy); "
                      f"model-axis collectives of one step ({b['n_coll']} "
                      f"all_reduces, {b['coll_bytes'] / 1e6:.3f} MB) replayed alone "
                      f"{b['coll_ms']:.2f} ms ({b['coll_ms'] / step:.3f} of the "
                      f"step); params {b['params_gb']:.2f} GB, peak "
                      f"{b['peak_gb']:.2f} GB (one process {peak1:.2f}); launches "
                      f"{b['launches']} (one process {l1}); argmax agreement "
                      f"{b['agree']:.3f}; f32 tokens exact, logits within "
                      f"{f['logits_rel']:.2e} of their range, {med(f['ms']):.2f} "
                      f"ms/step vs {one[name]['torch.float32'][0]:.2f}; bf16: "
                      f"{b['check']}; on the rank f32 {f['wall_s']:.1f} s, bf16 "
                      f"{b['wall_s']:.1f} s")
            if name == "recurrentgemma-2b":
                row["rank_launches"] = [
                    g[f"{name}/bfloat16"]["launches"]["decode_attention[partial]"]
                    for g in ranks]
    print(f"phase 12(b) {P12_BATCH} requests, bf16 at published width "
          f"(llama-3.2-vision-90b at 5 layers), f32 at one period: "
          f"{time.perf_counter() - t0:.1f} s with the one-process runs and the "
          f"ranks' start")
    return row


# phase 13: the disaggregated runtime on disjoint ranks, every rank a
# process on cuda:0 over gloo (with a card per rank: NCCL).  (a) f32, 2
# layers, 1 attention + 4 expert ranks (JAX's 4 expert devices of
# tests/test_multidevice.py:143), phase 2's placement workload: on 2
# expert ranks top-2 routing gives no expert more than the half of the
# picks a node serves anyway, so nothing is replicated; (b) bf16, phase
# 3's 4 layers, 1 prefill + 1 attention + 2 expert ranks
P13_A = dict(PLACE_F32, n_layers=2, attn_ranks=[0], expert_ranks=[1, 2, 3, 4])
P13_B = dict(PAGED, max_new=32)
P13_TIMEOUT = 420          # seconds for all ranks of one sub-phase
# 13(b)'s runs: contiguous; paged with the prefix cache on a cold tree
# (the worker prefills every request whole, as contiguous: tokens equal);
# paged after a warm request that publishes the shared prefix (every
# request a suffix prefill: bf16 rounds it unlike a whole prefill, and
# the tokens part where a near-tie flips, in one process too:
# scripts/paged_prefix_numerics.py)
P13_LAYOUTS = ("contiguous", "paged", "paged+warm")
# (kernel, its device function) counted per rank from the profiler
P13_KERNELS = (("decode_attention", "decode_attention_split"),
               ("gating_dispatch", "gating_dispatch_kernel"),
               ("grouped_matmul", "grouped_matmul_kernel"))


def p13_config(torch, spec, dtype, **kw):
    from repro_torch.serving.config import ServingConfig
    return ServingConfig(arch="mixtral-8x22b", n_layers=spec["n_layers"],
                         dtype=dtype, device="cuda", runtime="pingpong",
                         microbatches=spec["microbatches"],
                         max_batch=spec["max_batch"], max_seq=spec["max_seq"],
                         transport="multi", verbose=False, **kw)


def p13_profiled(torch, eng, prompts, max_new, warm=None):
    """Serve ``prompts`` (after ``warm``, served alone), profiling decode
    iterations 3-6 with torch.profiler: (tokens, seconds, device
    kernels of each P13_KERNELS function in the window, the host launch
    counts of the window, whether the session saw the device)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.cuda_build import launch_counts
    from repro_torch.serving.engine import Request
    if warm is not None:
        eng.submit(Request(rid=-1, prompt=list(warm), max_new_tokens=2))
        eng.run_until_done()
        eng.finished.clear()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=max_new))
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
    host = {k: v - before[k] for k, v in launch_counts().items()}
    eng.run_until_done()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dev = [e.name for e in device_events(torch, prof)]
    seen = {k: sum(fn in n for n in dev) for k, fn in P13_KERNELS}
    return ({r.rid: list(r.generated) for r in eng.finished if r.rid >= 0}, dt, seen,
            host, bool(dev))


def p13_rank_line(st):
    """Per rank of a run: role, decode ms per iteration (host clock), its
    stage times on the card, hops, params and peak."""
    reps = {r["rank"]: r for r in st.get("stages", {}).get("ranks", [])}
    out = []
    for r in st["ranks"]:
        ph, rep = r["phases"], reps.get(r["rank"], {})
        t = ""
        if rep.get("attn_n"):
            t = f", t_a {(rep['attn_s'] + rep['combine_s']) / rep['attn_n'] * 1e3:.3f} ms"
        elif rep.get("expert_n"):
            t = f", t_e {rep['expert_s'] / rep['expert_n'] * 1e3:.3f} ms"
        hops = " ".join(
            f"{k} {h['hops']} sent / {h['bytes'] / 1e6:.3f} MB"
            + (f", waited {h['wait_s'] * 1e3:.1f} ms over {h['waits']}"
               if "wait_s" in h else "")
            for k, h in r["transport"].items() if isinstance(h, dict))
        out.append(dict(rank=r["rank"], role=r["role"],
                        ms_per_iter=ph["decode_s"] * 1e3 / max(1, ph["decode_n"]),
                        line=f"rank {r['rank']} [{r['role']}]: "
                        f"{ph['decode_s'] * 1e3 / max(1, ph['decode_n']):.2f} ms/iter "
                        f"(host){t}; {hops or 'no hops'}; params "
                        f"{r['params_bytes'] / 1e9:.2f} GB, peak "
                        f"{r['peak_bytes'] / 1e9:.2f} GB"))
    return out


def p13a_child(torch, out_dir):
    """One rank of 13(a): ping-pong m = 2 on 1 attention + 4 expert ranks,
    f32, under the zipf router bias, rebalanced every 2 iterations,
    without and then with M2N on one runtime (the weights drawn once, in
    turn); each run profiled.  Prints one JSON line."""
    from repro_torch.config import get_config
    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import reset_launch_counts
    from repro_torch.launch.mesh import ServingRoles
    from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
    from repro_torch.launch.serve import draw_for_rank
    from repro_torch.serving.engine import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = MultiControllerTransport(device="cuda")
    tr.setup_serving(ServingRoles(tr.process_count, 0, attn_ranks=P13_A["attn_ranks"],
                                  expert_ranks=P13_A["expert_ranks"]))
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=P13_A["n_layers"])
    prompts = prompts_for(P13_A, cfg.vocab)
    base = p13_config(torch, P13_A, "float32", zipf_route_bias=PLACE["zipf"],
                      expert_rebalance_every=PLACE["rebalance_every"])
    res = {"rank": tr.process_index, "role": tr.roles.role(tr.process_index)}
    # one runtime for both runs (the expert ranks keep the router): the
    # M2N run starts from the placement the first run installed, so the
    # f32 slots (2.42 GB each, through gloo on the host) move once
    params = draw_for_rank(base.with_overrides(use_m2n=True), cfg, tr)
    runtime = DisaggregatedInstance(
        cfg, params, plan=DisaggPlan(n_microbatches=P13_A["microbatches"],
                                     use_m2n=True), transport=tr)
    if res["role"] == "expert":
        params = {}         # the runtime's slots replace its static experts
    for m2n in (False, True):
        runtime.plan.use_m2n = m2n
        eng = Engine(cfg, params, config=base.with_overrides(use_m2n=m2n),
                     runtime=runtime, transport=tr)
        tr.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        toks, dt, seen, host, saw = p13_profiled(torch, eng, prompts, P13_A["max_new"])
        st = eng.stats()
        res["m2n" if m2n else "dispatch"] = dict(
            tokens=toks, wall_s=dt, profiled=seen, host=host, saw_device=saw,
            rebalances=st["rebalances"], replicated=st["replicated_experts"],
            imbalance=st["imbalance"], transport=st["transport"],
            ranks=p13_rank_line(st))
        del eng
    print("phase13a " + json.dumps(res), flush=True)


def p13b_child(torch, out_dir):
    """One rank of 13(b): bf16, 1 prefill + 1 attention + 2 expert ranks,
    ping-pong m = 2 through the dispatch kernel path.  One decode step of
    the runtime from the parent's prefilled cache (the attention rank
    holds it against the parent's monolithic step by phase 3's rule), the
    contiguous layout with async KV transfer (profiled), then paged with
    the radix prefix cache on a cold tree and after a warm request (as
    phase 6): ``P13_LAYOUTS``.  Prints one JSON line."""
    from repro_torch.config import get_config
    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import reset_launch_counts
    from repro_torch.launch.mesh import ServingRoles
    from repro_torch.launch.serve import draw_for_rank, engine_for
    tr = MultiControllerTransport(device="cuda")
    tr.setup_serving(ServingRoles(tr.process_count, 1))
    me = tr.process_index
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=MAIN["n_layers"])
    prompts = prompts_for(P13_B, cfg.vocab)
    # one request a prefill batch: the inline path's B = 1 numerics, so
    # the paged run's suffix prefills meet what phase 4 holds in one
    # process (a batch of 8 rounds bf16 otherwise)
    base = p13_config(torch, P13_B, "bfloat16", prefill_devices=1, transfer="async",
                      prefill_chunk_tokens=P13_B["prompt_len"])
    params = draw_for_rank(base, cfg, tr)
    res = {"rank": me, "role": tr.roles.role(me)}
    eng = engine_for(base, cfg, params, tr)
    if res["role"] != "prefill":
        ref = (torch.load(Path(out_dir) / "ref_b.pt") if res["role"] == "attn"
               else None)
        toks = torch.load(Path(out_dir) / "ref_toks.pt").to(tr.device)
        pos = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32,
                         device=tr.device)
        cache = ([{k: v.to(tr.device) for k, v in e.items()} for e in ref["cache"]]
                 if ref is not None else None)
        with record_routing() as (_, pp):
            pp.active = True
            got, _ = eng.runtime.decode_microbatched(toks[:, -1], cache, pos,
                                                     eng.mb_slices)
        if ref is not None:
            calls = [tuple(t.to(tr.device) for t in c) for c in ref["calls"]]
            res["step"] = check_bf16_logits(torch, "phase 13(b) step", ref["want"]
                                            .to(tr.device), got, calls, pp.calls,
                                            cfg.n_layers)
        eng.runtime.reset_stage_times()
    tr.barrier()
    for layout in P13_LAYOUTS:
        if layout != "contiguous":
            eng = engine_for(base.with_overrides(kv_layout="paged",
                                                 page_size=P13_B["page_size"]),
                             cfg, params, tr)
        tr.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        toks, dt, seen, host, saw = p13_profiled(
            torch, eng, prompts, P13_B["max_new"],
            warm=warm_prompt(prompts[0], P13_B) if layout == "paged+warm" else None)
        st = eng.stats()
        res[layout] = dict(tokens=toks, wall_s=dt, profiled=seen, host=host,
                           saw_device=saw, transport=st["transport"],
                           phases=st["phases"], prefix=st.get("prefix_cache"),
                           decode_tok_s=(sum(map(len, toks.values())) - len(toks))
                           / max(st["phases"]["decode_s"], 1e-9),
                           ranks=p13_rank_line(st))
        del eng
        torch.cuda.empty_cache()
    print("phase13b " + json.dumps(res), flush=True)


def p13_reference_b(torch, dev, out_dir):
    """13(b)'s one-process reference: phase 3's bf16 model (drawn here,
    freed after) prefills phase 3's 8 x 16 step tokens, and its
    monolithic decode step's logits and routing are written beside the
    cache for the attention rank."""
    from repro_torch.config import get_config
    from repro_torch.models.transformer import decode_step, init_params, prefill
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=MAIN["n_layers"])
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    toks = torch.randint(2, cfg.vocab, (MAIN["max_batch"], MAIN["prompt_len"]),
                         device=dev, generator=torch.Generator(dev).manual_seed(1))
    _, cache = prefill(params, cfg, toks, max_seq=P13_B["max_seq"])
    pos = torch.full((MAIN["max_batch"],), MAIN["prompt_len"], dtype=torch.int32,
                     device=dev)
    with record_routing() as (mono, _):
        mono.active = True
        want, _ = decode_step(params, cfg, toks[:, -1], cache, pos)
    host = lambda t: t.to("cpu", copy=True)
    torch.save({"cache": [{k: host(v) for k, v in e.items()} for e in cache],
                "want": host(want), "calls": [(host(e), host(p)) for e, p in mono.calls]},
               Path(out_dir) / "ref_b.pt")
    torch.save(host(toks), Path(out_dir) / "ref_toks.pt")
    del params, cache
    torch.cuda.empty_cache()


def p13_one_process_a(torch, dev):
    """13(a)'s tokens in one process where phase 2 did not run: phase 2's
    static ping-pong over its 4 expert nodes."""
    from repro_torch.config import get_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=P13_A["n_layers"])
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    eng = build_engine(torch, cfg, zipf_params(torch, cfg, params), PLACE_F32,
                       "pingpong", nodes=PLACE["expert_nodes"])
    toks = serve(torch, eng, prompts_for(PLACE_F32, cfg.vocab), PLACE_F32["max_new"])[0]
    del eng, params
    torch.cuda.empty_cache()
    return toks


def phase_disagg_ranks(torch, dev, want_a=None):
    """Phase 13: the disaggregated runtime on disjoint ranks of cuda:0.
    (a) against phase 2's one-process tokens (``want_a``; computed here
    where phase 2 did not run); (b) one step against the parent's
    monolithic step, paged tokens equal to contiguous.  Prints each
    rank's role, ms per decode iteration, t_a / t_e, hops, params and
    peak.  Returns each P13_KERNELS kernel's per-rank device launches
    (13(b)'s contiguous window; ``gating_dispatch[owner]`` 13(a)'s m2n
    window)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "build" / "phase13"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if want_a is None:
        want_a = p13_one_process_a(torch, dev)
    p13_reference_b(torch, dev, out_dir)
    ranks = {}
    for sub, n in (("a", 1 + len(P13_A["expert_ranks"])), ("b", 4)):
        ta = time.perf_counter()
        out = run_ranks([str(ROOT / "chip_smoke.py"), "--phase13", sub, str(out_dir)],
                        n, timeout=P13_TIMEOUT)
        got = []
        failed = [(rank, rc, text) for rank, (rc, text) in enumerate(out) if rc]
        require(not failed, f"phase 13({sub}): ranks " + "; ".join(
            f"{rank} exited {rc}:\n{text[-2500:]}" for rank, rc, text in failed))
        for rank, (rc, text) in enumerate(out):
            lines = [ln for ln in text.splitlines() if ln.startswith(f"phase13{sub} ")]
            require(len(lines) == 1, f"phase 13({sub}): rank {rank} printed no "
                    f"result:\n{text[-4000:]}")
            got.append(json.loads(lines[0][len(f"phase13{sub} "):]))
        ranks[sub] = sorted(got, key=lambda g: g["rank"])
        print(f"phase 13({sub}): {n} ranks in {time.perf_counter() - ta:.1f} s")
    A, B = ranks["a"], ranks["b"]
    require([g["role"] for g in A] == ["attn"] + ["expert"] * 4,
            f"phase 13(a) roles {[g['role'] for g in A]}")
    require([g["role"] for g in B] == ["attn", "expert", "expert", "prefill"],
            f"phase 13(b) roles {[g['role'] for g in B]}")
    want_a = {int(k): v for k, v in want_a.items()}
    for run in ("dispatch", "m2n"):
        r0 = A[0][run]
        for g in A:
            toks = {int(k): v for k, v in g[run]["tokens"].items()}
            require(toks == want_a, f"phase 13(a) {run}: rank {g['rank']} tokens "
                    f"{toks} != one process's {want_a}")
        require(r0["rebalances"] > 0, f"phase 13(a) {run}: never rebalanced")
        require(r0["replicated"] >= 1, f"phase 13(a) {run}: no expert replicated")
        w = r0["transport"].get("weights", {})
        print(f"phase 13(a) [{run}] (f32, {P13_A['n_layers']} layers, 1 attention + 4 "
              f"expert ranks, zipf({PLACE['zipf']}), rebalance every "
              f"{PLACE['rebalance_every']}): tokens equal one process's for "
              f"{len(want_a)} requests; {r0['rebalances']} rebalances, "
              f"{r0['replicated']} replicated, imbalance {r0['imbalance']:.4f}; "
              f"weights hop {w.get('bytes', 0) / 1e9:.3f} GB in {w.get('hops', 0)} "
              f"hops; {r0['wall_s']:.2f} s")
        for line in r0["ranks"]:
            print(f"phase 13(a) [{run}] {line['line']}")
    for g in A:
        seen, host = g["m2n"]["profiled"], g["m2n"]["host"]
        require(g["m2n"]["saw_device"], f"phase 13(a): rank {g['rank']}'s profiler "
                f"saw no device kernel")
        owner = seen["gating_dispatch"]
        if g["role"] == "expert":
            require(owner > 0 and host["gating_dispatch[owner]"] > 0
                    and seen["grouped_matmul"] > 0,
                    f"phase 13(a) m2n: expert rank {g['rank']} launches {seen} {host}")
        else:
            require(owner == 0 and seen["decode_attention"] > 0,
                    f"phase 13(a) m2n: attention rank launches {seen}")
        print(f"phase 13(a) [m2n] rank {g['rank']} [{g['role']}] device kernels in 4 "
              f"decode iterations (profiler): "
              + " ".join(f"{k}={seen[k]}" for k, _ in P13_KERNELS)
              + "; host counts " + " ".join(f"{k}={v}" for k, v in host.items() if v))
    a0 = B[0]
    require("step" in a0, "phase 13(b): the attention rank held no step")
    print(f"phase 13(b) step (bf16, {MAIN['n_layers']} layers, m = 2, against one "
          f"process's monolithic step): {a0['step']}")
    contig = {int(k): v for k, v in a0["contiguous"]["tokens"].items()}
    require(len(contig) == P13_B["n_requests"], "phase 13(b): requests unfinished")
    parted = {}
    for g in B:
        for layout in P13_LAYOUTS:
            toks = {int(k): v for k, v in g[layout]["tokens"].items()}
            require(sorted(toks) == sorted(contig) and all(
                len(v) == P13_B["max_new"] for v in toks.values()),
                f"phase 13(b) {layout}: rank {g['rank']} requests unfinished")
            parted[layout] = [(r, next(i for i, (a, b) in enumerate(zip(toks[r],
                                                                          contig[r]))
                                       if a != b)) for r in contig if toks[r] != contig[r]]
            require(layout == "paged+warm" or toks == contig,
                    f"phase 13(b) {layout}: rank {g['rank']} tokens differ from the "
                    f"contiguous run's at (request, token) {parted[layout]}")
    for layout in P13_LAYOUTS[1:]:
        px = a0[layout]["prefix"]
        require(px["hits"] == (P13_B["n_requests"] if layout == "paged+warm" else 0),
                f"phase 13(b) {layout}: prefix {px}")
    for layout in P13_LAYOUTS:
        r = a0[layout]
        kv, px = r["transport"].get("kv", {}), r["prefix"]
        print(f"phase 13(b) [{layout}] (1 prefill + 1 attention + 2 expert ranks, "
              f"async KV): {P13_B['n_requests']} requests in {r['wall_s']:.2f} s, "
              f"{r['decode_tok_s']:.1f} tok/s decoding; kv {kv.get('hops', 0)} hops / "
              f"{kv.get('bytes', 0) / 1e6:.3f} MB"
              + (f"; prefix {px['hits']} hits / {px['misses']} misses; tokens part "
                 f"from contiguous at (request, token) {parted[layout]}"
                 if px else ""))
        for line in r["ranks"]:
            print(f"phase 13(b) [{layout}] {line['line']}")
    launches = {k: [] for k, _ in P13_KERNELS}
    for g in B:
        c = g["contiguous"]
        # the prefill rank has prefilled every request by the window: it
        # only meets the others' collectives there
        require(c["saw_device"] or g["role"] == "prefill",
                f"phase 13(b): rank {g['rank']}'s profiler saw no device kernel")
        seen = c["profiled"]
        for k, _ in P13_KERNELS:
            launches[k].append(seen[k])
        want_here = {"attn": ("decode_attention", "gating_dispatch"),
                     "expert": ("grouped_matmul",), "prefill": ()}[g["role"]]
        for k, _ in P13_KERNELS:
            require((seen[k] > 0) == (k in want_here),
                    f"phase 13(b): {g['role']} rank {g['rank']} launched {k} "
                    f"{seen[k]} times (profiler)")
        print(f"phase 13(b) rank {g['rank']} [{g['role']}] device kernels in 4 "
              f"decode iterations (profiler): "
              + " ".join(f"{k}={seen[k]}" for k, _ in P13_KERNELS)
              + "; host counts " + " ".join(f"{k}={v}" for k, v in c["host"].items() if v))
    launches["gating_dispatch[owner]"] = [g["m2n"]["profiled"]["gating_dispatch"]
                                          for g in A]
    print(f"phase 13 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the JAX dry run's other training layouts, and a
# sequence-parallel prefill, on a grid of processes
# ---------------------------------------------------------------------------

# (a) phase 10(b)'s model and grid: qwen2-moe-a2.7b at published width cut
# to one layer, f32 with TF32 off, batch 8 x seq 128, 3 steps on (2, 2);
# the layouts in one start of the ranks.  JAX's zero_extend names the data
# axes twice on the experts under fsdp and under ep2d here (60 experts
# split over m = 2, so the rules give them the data axes on another dim):
# those two layouts run without ZeRO-1 and the refusal is checked; ZeRO-1
# runs with sequence parallelism, m2n and m2n2d, as in the JAX dry run's
# train records.  "ref" is the one-process function each layout computes:
# "dense" the step on the whole batch, "blocks" the step whose experts
# route each data rank's rows apart (m2n's capacity)
P14A = dict(arch="qwen2-moe-a2.7b", grid=(2, 2), n_layers=1, batch=8, seq=128,
            steps=3, lr=1e-3, seed=0, loss_rtol=1e-5, grad_tol=1e-4)
P14_LAYOUTS = (("fsdp", dict(fsdp=True), "dense"),
               ("ep2d", dict(expert_mode="ep2d"), "dense"),
               ("seq-parallel+zero1", dict(seq_parallel=True, zero=True), "dense"),
               ("m2n2d+zero1", dict(moe_impl="m2n2d", zero=True), "dense"),
               ("m2n+zero1", dict(moe_impl="m2n", zero=True), "blocks"))
P14_REFUSED = (("fsdp+zero1", dict(fsdp=True, zero=True)),
               ("ep2d+zero1", dict(expert_mode="ep2d", zero=True)))
# (b) phase 11(a)'s f32 run (mixtral on (1, 2), 2 layers, 8 requests, 32
# greedy steps, the experts as m2n shards) with a sequence-parallel prefill
P14B = dict(which="a", n_layers=2)
P14_TIMEOUT = 420          # seconds for all ranks of one sub-phase
P14_KINDS = ("all-gather", "reduce-scatter", "all-reduce")


def p14a_setup(torch, dev):
    from repro_torch.config import get_config
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    R = P14A
    cfg = dataclasses.replace(get_config(R["arch"]), n_layers=R["n_layers"])
    opt = AdamWConfig(lr=R["lr"], warmup_steps=2, total_steps=R["steps"])
    batches = [torch.from_numpy(b).to(dev) for b in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=R["seq"] + 1, batch=R["batch"],
        seed=R["seed"])).batches(R["steps"])]
    return cfg, opt, batches


def p14_blocks_moe(n_blocks, dropped):
    """The one-process routed experts of ``n_blocks`` data ranks' rows,
    each row block (a contiguous block of the flat tokens) routed with its
    own capacity (``routed_experts_dense`` on the block), the outputs
    concatenated and the load-balance losses averaged: with one block the
    plain step's experts, with the data ranks' count m2n's (``core.m2n``'s
    plain branch over the ranks).  Adds the entries past their expert's
    capacity to ``dropped[-1]``."""
    import torch

    from repro_torch.models import moe as moe_lib

    def impl(params, x, cfg, act, capacity_mode, with_aux=False):
        ys, auxs = [], []
        for xb in x.chunk(n_blocks, 0):
            r = moe_lib.route(xb, params["router"], cfg.top_k,
                              params.get("router_bias"))
            C = moe_lib.expert_capacity(xb.shape[0], cfg, capacity_mode)
            counts = moe_lib.routing_counts(r, cfg.n_experts)
            dropped[-1] += float((counts - C).clamp(min=0).sum())
            y, a = moe_lib.routed_experts_dense(params, xb, cfg, act, capacity_mode,
                                                with_aux)
            ys.append(y)
            auxs.append(a)
        aux = torch.stack(auxs).mean() if with_aux else None
        return torch.cat(ys, 0), aux
    return impl


def p14a_one_process(torch, ref, dev, step0=False):
    """One process on the whole batch, 3 steps: ``ref`` "dense" (the plain
    step) or "blocks" (m2n's per-data-block routing, ``p14_blocks_moe``).
    Returns (each step's metrics, ms per step, peak GB), and with
    ``step0`` instead step 0's gradients and params after it, by path, on
    ``dev``."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import init_params
    from repro_torch.training import loop
    from repro_torch.training.optimizer import init_opt_state, leaves, named_leaves
    cfg, opt, batches = p14a_setup(torch, dev)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, P14A["seed"], torch.float32, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    state = init_opt_state(params)
    step = loop.make_train_step(cfg, opt, remat="none")
    kept, update = {}, loop.adamw_update
    host = lambda t: t.detach().clone()

    def keep(opt_cfg, ps, grads, st, **kw):
        if not kept:
            kept["grads"] = [host(g) for g in leaves(grads)]
        return update(opt_cfg, ps, grads, st, **kw)

    dropped = []
    prev = moe_lib.set_routed_impl(p14_blocks_moe(
        P14A["grid"][0] if ref == "blocks" else 1, dropped))
    metrics, ms = [], []
    loop.adamw_update = keep
    try:
        for toks in batches[:1] if step0 else batches:
            dropped.append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, toks)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(dict({k: float(v) for k, v in m.items()},
                                dropped=dropped[-1]))
    finally:
        loop.adamw_update = update
        moe_lib.set_routed_impl(prev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    names = [k for k, _ in named_leaves(params)]
    out = ((dict(zip(names, kept["grads"])), {k: host(p) for k, p in
                                              named_leaves(params)})
           if step0 else (metrics, ms, peak))
    del params, state
    torch.cuda.empty_cache()
    return out


def p14a_child(torch, out_dir):
    """One rank of 14(a), each layout of ``P14_LAYOUTS`` in turn: the
    rank's blocks drawn leaf by leaf (``init_params(place=Layout.place)``),
    the steps with every collective timed by kind on the host clock
    (between two synchronizes), the launch counts set to 0 before and
    read after; its state freed, then, one rank at a time (the others at
    a barrier), step 0 of the layout's one-process function on the whole
    batch (24 GB on the card), against which the rank holds its blocks
    of step 0's gradients (as AdamW updates them; 1e-4 of each leaf's
    max |g|) and of the params after step 0 (AdamW's first-step bound,
    phase 12(a)'s rule).  The reference is recomputed for each layout:
    kept on the host for the layouts that share it, its copies cost more
    than the recomputation (PERF.md §6).  Prints one JSON line."""
    import torch.distributed as dist

    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.training import data_parallel as dp
    from repro_torch.training import loop
    from repro_torch.training.optimizer import cosine_lr, leaves, named_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = MultiControllerTransport(device="cuda")
    rank, n = tr.process_index, tr.process_count
    mesh = make_mesh(P14A["grid"], ("data", "model"), device=tr.device)
    cfg, opt, batches = p14a_setup(torch, tr.device)
    lr = float(cosine_lr(opt, 1))
    res = {"rank": rank, "device": str(tr.device), "backend": tr.backend,
           "layouts": {}}
    orig = {k: getattr(mesh, k) for k in ("all_reduce", "all_gather", "reduce_scatter")}
    group_all_reduce = dp.group_all_reduce
    update = loop.adamw_update

    def run_layout(kw):
        """The layout's steps: (its figures, step 0's gradient blocks and
        gnorm, the params after step 0, the layout)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = loop.make_train_step(cfg, opt, remat="none", mesh=mesh, **kw)
        params = init_params(cfg, P14A["seed"], torch.float32, device=tr.device,
                             place=step.layout.place)
        for p in leaves(params):
            p.requires_grad_(True)
        state = step.layout.init_opt_state(params)
        gb = lambda tree: sum(t.numel() * t.element_size() for t in leaves(tree)) / 1e9
        r = {"params_gb": gb(params), "moments_gb": gb(state.mu) + gb(state.nu)}
        coll = {k: [] for k in P14_KINDS}
        coll_bytes = {k: 0 for k in P14_KINDS}
        kept = {}

        def timed(kind, fn):
            def call(t, *a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(t, *a, **k)
                torch.cuda.synchronize()
                coll[kind][-1] += (time.perf_counter() - t0) * 1e3
                nb = max(t.numel(), out.numel()) * t.element_size()
                coll_bytes[kind] += nb
                return out
            return call

        def keep(opt_cfg, ps, grads, st, **k):
            if not kept:
                kept["grads"] = [g.detach().clone() for g in leaves(grads)]
                kept["gnorm"] = float(k["gnorm"])
            return update(opt_cfg, ps, grads, st, **k)

        mesh.all_reduce = timed("all-reduce", orig["all_reduce"])
        mesh.all_gather = timed("all-gather", orig["all_gather"])
        mesh.reduce_scatter = timed("reduce-scatter", orig["reduce_scatter"])
        dp.group_all_reduce = timed("all-reduce", group_all_reduce)
        loop.adamw_update = keep
        metrics, ms = [], []
        reset_launch_counts()
        try:
            for s, toks in enumerate(batches):
                for k in P14_KINDS:
                    coll[k].append(0.0)
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, toks)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
                if s == 0:
                    after0 = {k: p.detach().clone() for k, p in named_leaves(params)}
        finally:
            for k in orig:
                delattr(mesh, k)
            dp.group_all_reduce = group_all_reduce
            loop.adamw_update = update
        r.update(metrics=metrics, ms=ms, coll_ms=coll, coll_bytes=coll_bytes,
                 launches={k: v for k, v in launch_counts().items() if v},
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del params, state
        torch.cuda.empty_cache()
        return r, kept, after0, step.layout

    def compare(lay, kept, after0, g_ref, p_ref):
        """(worst gradient gap of max |g|, leaf), the elements of step 0's
        params past AdamW's first-step bound, (worst share of it, leaf),
        against the one-process step 0 ``g_ref`` / ``p_ref``."""
        clip = min(1.0, opt.grad_clip / (kept["gnorm"] + 1e-9))
        g_worst, past, bound = (0.0, ""), 0, (0.0, "")
        for lf, g in zip(lay.leaves, kept["grads"], strict=True):
            k = lf.path
            want = lay.place(k, g_ref[k], "moment")
            if g.numel():
                e = float((g - want).abs().max()) / max(float(g_ref[k].abs().max()),
                                                        1e-30)
                g_worst = max(g_worst, (e, k))
            held = lay.moment_block(lf, after0[k])
            if held is None:
                continue
            pw = lay.place(k, p_ref[k], "moment")
            if not pw.numel():
                continue
            rng = float(pw.max() - pw.min()) or 1.0
            allowed = (lr * torch.clamp(clip * (g - want).abs() / opt.eps, max=2.0)
                       + 1e-5 * rng + 1e-6 * pw.abs())
            d = (held - pw).abs()
            past += int((d > allowed).sum())
            bound = max(bound, (float((d / allowed).max()), k))
        return g_worst, past, bound

    for name, kw, ref in P14_LAYOUTS:
        r, kept, after0, lay = run_layout(kw)
        for q in range(n):      # the one-process step 0 (24 GB) of one rank
            dist.barrier()
            if q == rank:
                out = compare(lay, kept, after0,
                              *p14a_one_process(torch, ref, tr.device, step0=True))
                torch.cuda.empty_cache()
        r.update(zip(("grad_worst", "params_past", "params_bound"), out), ref=ref)
        res["layouts"][name] = r
        del kept, after0
        dist.barrier()
    print("phase14a " + json.dumps(res), flush=True)


def p14b_child(torch, out_dir):
    """One rank of 14(b): phase 11(a)'s f32 run on its grid with a
    sequence-parallel prefill (the rank's blocks drawn leaf by leaf, the
    experts as m2n shards over "model"), profiled whole: the tokens equal
    one process's, the logits within 5e-4 of their range, each kernel's
    device launches (torch.profiler) equal to ``p11_predicted``.  Then
    the prefill alone with and without the flag, 3 times each: ms (host
    clock) and the collectives' bytes by kind.  Prints one JSON line."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.m2n import use_m2n
    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import ModelParallel
    from repro_torch.models.transformer import init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    which, L = P14B["which"], P14B["n_layers"]
    P, R = P11[which], P11_RUN
    tr = MultiControllerTransport(device="cuda")
    mesh = make_mesh(P["grid"], ("data", "model"), device=tr.device)
    dev, rank = tr.device, tr.process_index
    cfg = p11_cfg(which, L)
    lay = sharding.Layout(cfg, mesh)
    params = init_params(cfg, R["seed"], torch.float32, device=dev, place=lay.place)
    prompts = p11_prompts(torch, which, cfg, dev)
    ref = torch.load(Path(out_dir) / "p14b-float32.pt")  # phase 11(a)'s f32 run
    res = {"rank": rank, "device": str(dev), "backend": tr.backend}
    for attempt in range(SESSIONS):
        if attempt:
            time.sleep(1.0)
        dist.barrier()
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with ModelParallel(mesh, seq_parallel=True).install(), \
                    use_m2n(mesh=mesh, expert_axis="model"):
                logits, toks, ms, _ = p11_serve(torch, cfg, params, prompts,
                                                P["max_seq"], steps=R["steps"])
            torch.cuda.synchronize()
        host = {k: v for k, v in launch_counts().items() if v}
        names = [e.name for e in device_events(torch, prof)]
        if names:
            break
    require(bool(names), f"phase 14(b) rank {rank}: torch.profiler saw no device "
            f"activity in {SESSIONS} sessions")
    seen = {k: sum(fn in nm for nm in names) for k, fn in P13_KERNELS}
    want = p11_predicted(which, L)
    want_dev = {k: want[k] for k, _ in P13_KERNELS}
    require(seen == want_dev, f"phase 14(b) rank {rank}: device launches {seen}, "
            f"predicted {want_dev}")
    require(host == {k: v for k, v in want.items() if v},
            f"phase 14(b) rank {rank}: host launches {host}, predicted {want}")
    require(torch.equal(toks, ref["tokens"]), f"phase 14(b) rank {rank}: greedy "
            f"tokens differ from one process's")
    worst = max(float((g - w).abs().max() / w.abs().max())
                for g, w in zip(logits, ref["logits"], strict=True))
    require(worst <= 5e-4, f"phase 14(b) rank {rank}: logits off by {worst:.3e} of "
            f"their range")
    orig = {k: getattr(mesh, k) for k in ("all_reduce", "all_gather", "reduce_scatter")}
    kinds = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter"}
    timing = {}
    for sp in (True, False):
        nbytes = {k: 0 for k in P14_KINDS}

        def counted(kind, fn):
            def call(t, *a, **k):
                out = fn(t, *a, **k)
                nbytes[kind] += max(t.numel(), out.numel()) * t.element_size()
                return out
            return call

        for k in orig:
            setattr(mesh, k, counted(kinds[k], orig[k]))
        reps = []
        try:
            for i in range(3):
                if i == 1:
                    for k in orig:
                        setattr(mesh, k, orig[k])
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad(), ModelParallel(mesh, seq_parallel=sp).install(), \
                        use_m2n(mesh=mesh, expert_axis="model"):
                    prefill(params, cfg, prompts, max_seq=P["max_seq"])
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) * 1e3)
        finally:
            for k in orig:
                if k in mesh.__dict__:
                    delattr(mesh, k)
        timing["seq_parallel" if sp else "plain"] = {
            "ms": reps, "bytes": nbytes}
    res.update(logits_rel=worst, ms=ms, device_launches=seen, launches=host,
               prefill=timing, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    dist.barrier()
    print("phase14b " + json.dumps(res), flush=True)


def p14_ranks(torch, which, n, label):
    out_dir = ROOT / "build" / "phase14"
    out = run_ranks([str(ROOT / "chip_smoke.py"), "--phase14", which, str(out_dir)],
                    n, timeout=P14_TIMEOUT)
    failed = [(rank, rc, text) for rank, (rc, text) in enumerate(out) if rc != 0]
    # a rank that lost a peer fails at its next collective: show the others first
    failed.sort(key=lambda f: "closed by peer" in f[2])
    require(not failed, f"{label}: ranks {[f[0] for f in failed]} exited "
            f"{[f[1] for f in failed]}:\n" + "\n".join(
                f"--- rank {r} ---\n{text[-2500:]}" for r, _, text in failed[:2]))
    ranks = []
    for rank, (rc, text) in enumerate(out):
        tag = f"phase14{which} "
        lines = [ln for ln in text.splitlines() if ln.startswith(tag)]
        require(len(lines) == 1, f"{label}: rank {rank} printed no result:\n"
                f"{text[-4000:]}")
        ranks.append(json.loads(lines[0][len(tag):]))
    return sorted(ranks, key=lambda g: g["rank"])


def phase_layouts(torch, dev, p11_ref=None):
    """Phase 14.  (a) qwen2-moe-a2.7b (phase 10(b)'s model and grid)
    under the JAX dry run's other training layouts in one start of the
    ranks: fsdp, ep2d, and sequence parallelism, m2n2d and m2n with
    ZeRO-1 (fsdp and ep2d with ZeRO-1 are JAX's own ``DuplicateSpecError``
    here, and the port's).  Each layout's losses and aux within 1e-5 relative of
    its one-process function's ("dense": the plain step; "blocks": m2n's
    experts routing each data rank's rows apart, ``p14_blocks_moe``), the
    entries dropped equal where the experts route the global batch, step
    0's gradient blocks within 1e-4 of each leaf's max |g|, step 0's
    params within AdamW's first-step bound, no kernel launched; per rank
    ms/step, each collective kind's share, params, moments and peak.
    (b) phase 11(a)'s f32 run with a sequence-parallel prefill: tokens
    exact, logits within 5e-4 of their range, the profiler's launches as
    predicted; the prefill's ms and collective bytes by kind beside the
    same prefill without the flag.  ``p11_ref``: phase 11(a)'s f32
    one-process result of this run (its tokens and logits), else run
    here.  Returns {kernel: [each 14(b) rank's device launches]}."""
    import contextlib

    from repro_torch.core.m2n import use_m2n
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "build" / "phase14"
    out_dir.mkdir(parents=True, exist_ok=True)
    med = lambda xs: statistics.median(xs[1:]) if len(xs) > 1 else xs[0]
    R = P14A
    t0 = time.perf_counter()
    print(f"phase 14: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated in "
          f"this process before the ranks start")
    cfg, _, _ = p14a_setup(torch, dev)
    for name, kw in P14_REFUSED:
        try:
            sharding.Layout(cfg, RecordingMesh(R["grid"], ("data", "model")), **kw)
            require(False, f"phase 14(a) {name}: JAX's zero_extend refuses it, the "
                    f"port's layout did not")
        except sharding.DuplicateSpecError as e:
            print(f"phase 14(a) {name}: refused as JAX refuses it: {e}")
    refs = {ref: p14a_one_process(torch, ref, dev) for ref in ("dense", "blocks")}
    ranks = p14_ranks(torch, "a", R["grid"][0] * R["grid"][1], "phase 14(a)")
    tok = R["batch"] * R["seq"]
    for name, kw, ref in P14_LAYOUTS:
        want = refs[ref][0]
        for g in ranks:
            r = g["layouts"][name]
            for s, (m, w) in enumerate(zip(r["metrics"], want, strict=True)):
                for key in ("loss", "aux"):
                    require(abs(m[key] - w[key]) <= R["loss_rtol"] * abs(w[key]),
                            f"phase 14(a) {name} rank {g['rank']} step {s}: {key} "
                            f"{m[key]} vs {w[key]} (one process, {ref})")
                if "dropped" in m:
                    require(m["dropped"] == w["dropped"] and m["dropped"] > 0,
                            f"phase 14(a) {name} step {s}: dropped {m['dropped']} vs "
                            f"{w['dropped']}")
            require(r["grad_worst"][0] <= R["grad_tol"], f"phase 14(a) {name} rank "
                    f"{g['rank']}: gradient {r['grad_worst'][1]} off by "
                    f"{r['grad_worst'][0]:.2e} of its max |g|")
            require(r["params_past"] == 0, f"phase 14(a) {name} rank {g['rank']}: "
                    f"{r['params_past']} elements of step 0's params past AdamW's "
                    f"first-step bound (worst {r['params_bound']})")
            require(not r["launches"], f"phase 14(a) {name}: the training path "
                    f"launched {r['launches']}")
            step = med(r["ms"])
            shares = ", ".join(f"{k} {med(r['coll_ms'][k]):.2f} ms "
                               f"({med(r['coll_ms'][k]) / step:.3f}, "
                               f"{r['coll_bytes'][k] / len(r['ms']) / 1e9:.3f} GB a step)"
                               for k in P14_KINDS)
            print(f"phase 14(a) {name} rank {g['rank']} on {g['device']} over "
                  f"{g['backend']}: {step:.2f} ms/step (median of steps 2-"
                  f"{R['steps']}); {shares}; params {r['params_gb']:.3f} GB, moments "
                  f"{r['moments_gb']:.3f} GB, peak {r['peak_gb']:.2f} GB; worst "
                  f"gradient {r['grad_worst'][0]:.2e} of max |g| "
                  f"({r['grad_worst'][1]}), step 0's params within "
                  f"{r['params_bound'][0]:.3f} of the bound; ms "
                  f"{[round(x, 1) for x in r['ms']]}")
        r0 = ranks[0]["layouts"][name]
        print(f"phase 14(a) {name} against one process ({ref}): losses "
              f"{[m['loss'] for m in r0['metrics']]} vs {[m['loss'] for m in want]}, "
              f"aux {[m['aux'] for m in r0['metrics']]}, dropped "
              f"{[m.get('dropped') for m in r0['metrics']]} vs "
              f"{[m.get('dropped') for m in want]}")
    for ref, (want, ms, peak) in refs.items():
        print(f"phase 14(a) one process ({ref}): {med(ms):.2f} ms/step "
              f"({tok / med(ms) * 1e3:.1f} tok/s), peak {peak:.2f} GB")
    print(f"phase 14(a): {time.perf_counter() - t0:.1f} s with the one-process runs "
          f"and the ranks' start")
    # (b)
    t0 = time.perf_counter()
    which, L = P14B["which"], P14B["n_layers"]
    P, R11 = P11[which], P11_RUN
    cfg = p11_cfg(which, L)
    if p11_ref is not None:
        shutil.copy(p11_ref, out_dir / "p14b-float32.pt")
    else:
        params = init_params(cfg, R11["seed"], torch.float32, device=dev)
        prompts = p11_prompts(torch, which, cfg, dev)
        with use_m2n(1) if P["m2n"] else contextlib.nullcontext():
            logits, toks, _, _ = p11_serve(torch, cfg, params, prompts, P["max_seq"],
                                           steps=R11["steps"])
        torch.save({"logits": logits, "tokens": toks}, out_dir / "p14b-float32.pt")
        del params
        torch.cuda.empty_cache()
    ranks = p14_ranks(torch, "b", P["grid"][0] * P["grid"][1], "phase 14(b)")
    for g in ranks:
        sp, plain = g["prefill"]["seq_parallel"], g["prefill"]["plain"]
        gbs = lambda b: ", ".join(f"{k} {b[k] / 1e6:.3f} MB" for k in P14_KINDS)
        print(f"phase 14(b) rank {g['rank']} on {g['device']} over {g['backend']}: "
              f"tokens equal one process's, logits within {g['logits_rel']:.3e} of "
              f"their range, device launches {g['device_launches']}; prefill with "
              f"the flag {med(sp['ms']):.2f} ms ({gbs(sp['bytes'])}), without "
              f"{med(plain['ms']):.2f} ms ({gbs(plain['bytes'])}); decode "
              f"{statistics.median(g['ms'][1:]):.2f} ms/step; peak {g['peak_gb']:.2f} GB")
    print(f"phase 14(b): {time.perf_counter() - t0:.1f} s with the one-process run "
          f"and the ranks' start")
    return {k: [g["device_launches"][k] for g in ranks] for k, _ in P13_KERNELS}


def phase14_child(argv) -> int:
    """``chip_smoke.py --phase14 a|b OUT_DIR``: one rank of phase 14(a) or
    (b), started by ``phase_layouts`` with the ``REPRO_*`` variables, on
    cuda:0 over gloo (or its own card over NCCL)."""
    import torch
    sys.path.insert(0, str(SRC))
    {"a": p14a_child, "b": p14b_child}[argv[0]](torch, argv[1])
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase13_child(argv) -> int:
    """``chip_smoke.py --phase13 a|b OUT_DIR``: one rank of phase 13(a) or
    (b), started by ``phase_disagg_ranks`` with the ``REPRO_*`` variables,
    on cuda:0 over gloo (or its own card over NCCL)."""
    import torch
    sys.path.insert(0, str(SRC))
    {"a": p13a_child, "b": p13b_child}[argv[0]](torch, argv[1])
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase12_child(argv) -> int:
    """``chip_smoke.py --phase12 a|1x4|1x2 OUT_DIR``: one rank of phase
    12(a) or of 12(b) on one grid, started by ``phase_every_kind`` with
    the ``REPRO_*`` variables, on cuda:0 over gloo."""
    import torch
    sys.path.insert(0, str(SRC))
    if argv[0] == "a":
        p12_train_child(torch, argv[1])
    else:
        p12_serve_child(torch, argv[0], argv[1])
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase11_child(argv) -> int:
    """``chip_smoke.py --phase11 a|b OUT_DIR``: one rank of phase 11(a) or
    (b), started by ``phase_serving_grid`` with the ``REPRO_*``
    variables, on cuda:0 over gloo (or its own card over NCCL)."""
    import torch
    sys.path.insert(0, str(SRC))
    p11_child(torch, argv[0], argv[1])
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase10_child(argv) -> int:
    """``chip_smoke.py --phase10 a|b OUT_DIR``: one rank of phase 10(a) or
    (b), started by ``phase_model_axis`` with the ``REPRO_*`` variables;
    with a card per rank it takes its own (NCCL), else cuda:0 (gloo)."""
    import torch
    sys.path.insert(0, str(SRC))
    p10_child(torch, argv[0], argv[1])
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase9_child(argv) -> int:
    """``chip_smoke.py --phase9 m2n|dp OUT_DIR``: one rank of phase 9(a)
    or (c), started by ``phase_processes`` with the ``REPRO_*`` variables."""
    import torch
    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(0)
    {"m2n": p9_m2n_child, "dp": p9_dp_child}[argv[0]](torch, argv[1])
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    rank_forker()       # imports torch while the kernels build
    from repro_torch.config import get_config
    from repro_torch.kernels import ops as _  # noqa: F401  registers kernels
    from repro_torch.kernels.cuda_build import REGISTRY, build_all
    from repro_torch.models.transformer import init_params

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        libs = build_all()
        print(f"built {len(libs)} kernel libraries in "
              f"{time.perf_counter() - t0:.1f} s")
        for src, lib in sorted(libs.items()):
            log = lib.with_suffix(".log")
            rep = ptxas_report(log.read_text()) if log.exists() else []
            if not rep:
                print(f"  {src}: cached build")
            for name, (_, regs, smem, st, ld) in zip(demangle([r[0] for r in rep]),
                                                     rep):
                print(f"  {src}: {name}: {regs} registers, {smem} bytes smem, "
                      f"spill stores {st} B, loads {ld} B")
        rows = phase_kernels(torch, dev)
        cfg = get_config("mixtral-8x22b")
        placed_tokens = phase_f32_parity(torch, dev, cfg)
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, n_layers=MAIN["n_layers"])
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        launches, stages = phase_bf16_serving(torch, dev, cfg, params)
        for name in launches.keys() & rows.keys():
            rows[name]["launches"] = launches[name]
        planner_line(torch, cfg, stages)
        live = phase_paged_serving(torch, dev, cfg, params)
        rows["paged_decode_attention"] = live["paged_decode_attention"]
        # the live launch's row, with phase 1's shapes
        rows["gating_topk"] = dict(live["gating_topk"],
                                   shapes=rows["gating_topk"]["shapes"])
        torch.cuda.empty_cache()
        for name, n in phase_placement_serving(torch, dev, cfg, params).items():
            rows[name]["launches"] = n
        torch.cuda.empty_cache()
        phase_prefill_cluster(torch, dev, cfg, params)
        del params
        torch.cuda.empty_cache()
        path_launches = phase_registry(torch, dev)
        torch.cuda.empty_cache()
        t8 = time.perf_counter()
        phase_train_parity(torch, dev)
        phase_train(torch, dev)
        torch.cuda.empty_cache()
        t9 = time.perf_counter()
        for name, per_rank in phase_processes(torch, dev).items():
            rows[name]["rank_launches"] = per_rank
        torch.cuda.empty_cache()
        t10 = time.perf_counter()
        phase_model_axis(torch, dev)
        torch.cuda.empty_cache()
        t11 = time.perf_counter()
        rows["decode_attention[partial]"] = phase_serving_grid(torch, dev)
        torch.cuda.empty_cache()
        t12 = time.perf_counter()
        p12_row = phase_every_kind(torch, dev)
        torch.cuda.empty_cache()
        t13 = time.perf_counter()
        p13 = phase_disagg_ranks(torch, dev, placed_tokens)
        torch.cuda.empty_cache()
        t14 = time.perf_counter()
        p14 = phase_layouts(torch, dev, ROOT / "build" / "phase11" / "p11a-float32.pt")
        t_end = time.perf_counter()
        partial = rows["decode_attention[partial]"]
        partial["phase12_rank_launches"] = p12_row["rank_launches"]
        partial["shapes"] = [dict(partial, model="minitron-4b (phase 11(b))",
                                  path_launches=partial["launches"]),
                             dict(p12_row, model="recurrentgemma-2b (phase 12(b))",
                                  path_launches=p12_row["rank_launches"][0])]
        for name in ("decode_attention", "gating_dispatch", "grouped_matmul"):
            for sh in rows[name]["shapes"]:
                if "model" in sh:
                    sh["path_launches"] = path_launches[sh["model"]][name]
        kernels = []
        for name in ("decode_attention", "decode_attention[partial]",
                     "paged_decode_attention", "gating_topk",
                     "gating_dispatch", "gating_dispatch[tables]",
                     "gating_dispatch[owner]", "grouped_matmul"):
            r, src = rows[name], f"{name.split('[')[0]}.cu"
            require(src in REGISTRY, f"{src} not registered")
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}", "replaces": r["replaces"],
                "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
            if "rank_launches" in r:
                phase = 11 if name == "decode_attention[partial]" else 9
                kernels[-1][f"phase{phase}_rank_launches"] = r["rank_launches"]
            if name == "decode_attention[partial]":
                kernels[-1]["shape"] = r["shape"]
                kernels[-1]["phase12_rank_launches"] = r["phase12_rank_launches"]
            if name in p13:
                kernels[-1]["phase13_rank_launches"] = p13[name]
            if name in p14:
                kernels[-1]["phase14_rank_launches"] = p14[name]
            if "shapes" in r:
                kernels[-1]["shapes"] = [
                    {"shape": sh["shape"], "max_abs_err": sh["err"], "ms": sh["ms"],
                     # the decode shapes time no plain version and no library call
                     "plain_ms": sh.get("plain_ms"), "bound_ms": sh["bound"][0],
                     "bound_by": sh["bound"][1], "library_ms": sh.get("library_ms"),
                     **{k: sh[k] for k in ("fma_ms", "mma_ms", "dispatch_ms", "model",
                                           "path_launches") if k in sh}}
                    for sh in r["shapes"]]
        require({Path(k["source"]).name for k in kernels} == set(REGISTRY),
                "a registered kernel has no row")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: phases 1-7 in {t8 - t_start:.1f} s (the build included), "
          f"phase 8 in {t9 - t8:.1f} s, phase 9 in {t10 - t9:.1f} s, phase 10 in "
          f"{t11 - t10:.1f} s, phase 11 in {t12 - t11:.1f} s, phase 12 in "
          f"{t13 - t12:.1f} s, phase 13 in {t14 - t13:.1f} s, phase 14 in "
          f"{t_end - t14:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase10_only() -> int:
    """``chip_smoke.py --phase10-only``: phase 10 alone (no kernel build:
    the training path launches none).  On a machine with a card per rank
    its ranks meet over NCCL."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card_line()}, "
          f"{torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    try:
        phase_model_axis(torch, torch.device("cuda", 0))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: phase 10 in {time.perf_counter() - t0:.1f} s")
    return 0


def phase11_only() -> int:
    """``chip_smoke.py --phase11-only``: phase 11 alone (its kernels built
    first, one ``nvcc`` per source)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops as _  # noqa: F401  registers kernels
    from repro_torch.kernels.cuda_build import build_all
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card_line()}, "
          f"{torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    try:
        build_all()
        t1 = time.perf_counter()
        row = phase_serving_grid(torch, torch.device("cuda", 0))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: build {t1 - t0:.1f} s, phase 11 in "
          f"{time.perf_counter() - t1:.1f} s; partial row "
          f"{json.dumps({k: v for k, v in row.items() if k != 'replaces'})}")
    return 0


def phase12_only() -> int:
    """``chip_smoke.py --phase12-only``: phase 12 alone (its kernels built
    first, one ``nvcc`` per source)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops as _  # noqa: F401  registers kernels
    from repro_torch.kernels.cuda_build import build_all
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card_line()}, "
          f"{torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    try:
        build_all()
        t1 = time.perf_counter()
        row = phase_every_kind(torch, torch.device("cuda", 0))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: build {t1 - t0:.1f} s, phase 12 in "
          f"{time.perf_counter() - t1:.1f} s; partial row at hd 256 "
          f"{json.dumps({k: v for k, v in row.items()})}")
    return 0


def phase13_only() -> int:
    """``chip_smoke.py --phase13-only``: phase 13 alone (its kernels built
    first, one ``nvcc`` per source; 13(a)'s one-process tokens computed
    here)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops as _  # noqa: F401  registers kernels
    from repro_torch.kernels.cuda_build import build_all
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card_line()}, "
          f"{torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    try:
        build_all()
        t1 = time.perf_counter()
        launches = phase_disagg_ranks(torch, torch.device("cuda", 0))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: build {t1 - t0:.1f} s, phase 13 in "
          f"{time.perf_counter() - t1:.1f} s; per-rank launches {json.dumps(launches)}")
    return 0


def phase14_only() -> int:
    """``chip_smoke.py --phase14-only``: phase 14 alone (its kernels built
    first, one ``nvcc`` per source)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops as _  # noqa: F401  registers kernels
    from repro_torch.kernels.cuda_build import build_all
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card_line()}, "
          f"{torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    try:
        build_all()
        t1 = time.perf_counter()
        launches = phase_layouts(torch, torch.device("cuda", 0))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: build {t1 - t0:.1f} s, phase 14 in "
          f"{time.perf_counter() - t1:.1f} s; per-rank launches {json.dumps(launches)}")
    return 0


# ------------------------------------------------------ rank processes
# Every rank of phases 9-14 is forked from one process that imported
# torch and the port and ran a meta-device draw (touching no card) when
# the smoke started, so a group of ranks starts without each rank doing
# that anew on the host's shared cores (scripts/time_rank_start.py times
# both ways).
_FORKER = None


def rank_forker():
    """The running forker process (started here on first use)."""
    global _FORKER
    if _FORKER is None or _FORKER.poll() is not None:
        _FORKER = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                    "--rank-forker"], stdin=subprocess.PIPE,
                                   stdout=subprocess.PIPE, text=True)
    return _FORKER


def stop_rank_forker():
    """End the forker (its stdin closed; killed if it does not leave)."""
    global _FORKER
    if _FORKER is None:
        return
    try:
        _FORKER.stdin.close()
        _FORKER.wait(timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        _FORKER.kill()
        _FORKER.wait()
    _FORKER = None


def run_ranks(argv, procs: int, *, timeout: float):
    """Run ``chip_smoke.py`` with ``argv[1:]`` (a rank entry point of
    ``RANK_CHILDREN``) as ``procs`` ranks forked by the forker, with the
    ``REPRO_*`` variables of ``repro_torch.launch.dist_smoke.run_ranks``,
    under one deadline (every rank still running then is killed).
    Returns [(exit code, output)] per rank, -9 for a killed one."""
    fk = rank_forker()
    t0 = time.perf_counter()
    fk.stdin.write(json.dumps({"argv": [str(a) for a in argv[1:]], "procs": procs,
                               "timeout": timeout}) + "\n")
    fk.stdin.flush()
    line = fk.stdout.readline()
    require(bool(line), f"the rank forker exited ({fk.poll()}) on {argv[1:]}")
    print(f"ranks {' '.join(map(str, argv[1:3]))}: {procs} forked, done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return [tuple(r) for r in json.loads(line)]


def fork_ranks(argv, procs: int, timeout: float):
    """In the forker: fork ``procs`` ranks of the entry point ``argv``,
    each writing its output to a file of its own, and wait for them."""
    import signal
    import socket
    import tempfile
    import traceback

    from repro_torch.launch.dist_smoke import ENV_COORD, ENV_NPROC, ENV_PID
    # a fork copies only the calling thread: safe while it is the only one
    # (importing torch and a meta draw start none)
    if len(os.listdir("/proc/self/task")) != 1:
        raise RuntimeError("the rank forker has threads; a fork could deadlock")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    outs, pids = [], []
    for rank in range(procs):
        out = tempfile.TemporaryFile()
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:                        # the rank
            rc = 1
            try:
                null = os.open(os.devnull, os.O_RDONLY)
                os.dup2(null, 0)
                os.dup2(out.fileno(), 1)
                os.dup2(out.fileno(), 2)
                os.environ.update({ENV_COORD: coord, ENV_NPROC: str(procs),
                                   ENV_PID: str(rank)})
                rc = RANK_CHILDREN[argv[0]](argv[1:])
            except BaseException:
                traceback.print_exc()
            child_exit(rc)
        outs.append(out)
        pids.append(pid)
    deadline = time.monotonic() + timeout
    rcs = {}
    while len(rcs) < procs and time.monotonic() < deadline:
        for pid in pids:
            if pid not in rcs:
                done, status = os.waitpid(pid, os.WNOHANG)
                if done:
                    rcs[pid] = os.waitstatus_to_exitcode(status)
        time.sleep(0.05)
    for pid in pids:
        if pid not in rcs:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            rcs[pid] = -9
    res = []
    for pid, out in zip(pids, outs):
        out.seek(0)
        text = out.read().decode(errors="replace")
        out.close()
        res.append((rcs[pid], text + ("\n[parent] TIMEOUT" if rcs[pid] == -9 else "")))
    return res


def forker_imports():
    """What every rank would otherwise do first, done once in the forker:
    import torch, the port's modules the ranks import, and a meta-device
    draw of each layer kind (a process's first meta op imports torch's
    Python meta kernels, which takes seconds).  Starts no thread and
    touches no card."""
    import torch  # noqa: F401
    import torch.distributed  # noqa: F401

    import repro_torch.core.disagg  # noqa: F401
    import repro_torch.launch.serve  # noqa: F401
    import repro_torch.launch.sharding  # noqa: F401
    import repro_torch.training.data_parallel  # noqa: F401
    import repro_torch.training.loop  # noqa: F401
    from repro_torch.config import get_config, reduced
    from repro_torch.models.transformer import init_params
    for name in ("mixtral-8x22b", "recurrentgemma-2b", "mamba2-1.3b",
                 "whisper-large-v3", "llama-3.2-vision-90b"):
        init_params(reduced(get_config(name)), device="meta")


def rank_forker_main() -> int:
    """``chip_smoke.py --rank-forker``: import torch once (one OpenMP
    thread, as every rank), then fork the groups of ranks asked for on
    stdin, one JSON request a line, answering each on stdout."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    sys.path.insert(0, str(SRC))
    forker_imports()
    for line in sys.stdin:
        req = json.loads(line)
        res = fork_ranks(req["argv"], req["procs"], req["timeout"])
        sys.stdout.write(json.dumps(res) + "\n")
        sys.stdout.flush()
    return 0


def child_exit(rc: int):
    """Leave a rank process without the interpreter's finalization, where
    the gloo groups' leftover C++ objects can abort it ("terminate called
    without an active exception", no Python frame) after its result line
    is printed."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


# the rank entry points, by flag: ``chip_smoke.py FLAG ARGS...``
RANK_CHILDREN = {"--phase9": phase9_child, "--phase10": phase10_child,
                 "--phase11": phase11_child, "--phase12": phase12_child,
                 "--phase13": phase13_child, "--phase14": phase14_child}
ONLY = {"--phase10-only": phase10_only, "--phase11-only": phase11_only,
        "--phase12-only": phase12_only, "--phase13-only": phase13_only,
        "--phase14-only": phase14_only}

if __name__ == "__main__":
    flag = sys.argv[1] if len(sys.argv) > 1 else None
    if flag in RANK_CHILDREN:
        child_exit(RANK_CHILDREN[flag](sys.argv[2:]))
    if flag == "--rank-forker":
        sys.exit(rank_forker_main())
    try:
        sys.exit(ONLY.get(flag, main)())
    finally:
        stop_rank_forker()
