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
     which must be one, one and two (``dispatch_launches``), the
     grouped matmul at the up and the down projection with each of
     its two compute bodies (beside ``torch.bmm``).  The three serving
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

Phase 1 also holds the three serving kernels at phase 7's shapes: decode
attention at head_dim 256 with 10 heads on 1 over a wrapped 2048-slot
ring (recurrentgemma-2b), at head_dim 128 with softcap 50 (gemma2-27b)
and head_dim 64 with 20 heads on 20 (whisper-large-v3), the paged kernel
at head_dim 256; gating dispatch at 60 experts top-4 (d 2048) and 128
experts top-2 (d 7168) for T = 4 and 8; the grouped matmul's up and down
projections of both at M = 4.  After phase 3 it prints the planner's
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

After the build it prints each kernel's registers, shared memory and
spills from ``nvcc -Xptxas -v``.  Each decode profile (phases 3 and 4)
requires one device kernel per ``gating_dispatch`` call.  Before the
last line it prints the card's name and power limit and a
``{"kernels": [...]}`` line (decode attention, gating dispatch and the
grouped matmul carry a ``shapes`` list, one entry per timed shape;
``gating_dispatch[tables]`` and ``gating_dispatch[owner]`` are the
kernel's two branches, their launches counted on phase 5's rebalanced
and m2n + rebalanced runs); the last line is the contract line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line.  It imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
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


def require_dispatch_kernels(torch, gd_mod, fn, T, label):
    """The device kernels of one gating_dispatch call ``fn`` at T tokens,
    counted by torch.profiler, must be the wrapper's
    ``dispatch_launches(T)``; returns the count."""
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
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    require(bool(names), f"{label}: torch.profiler recorded no device activity "
            f"in {SESSIONS} sessions")
    n = sum("gating_dispatch" in name for name in names)
    require(n == gd_mod.dispatch_launches(T),
            f"{label}: one call ran {n} gating_dispatch device kernels, "
            f"expected {gd_mod.dispatch_launches(T)} (device events {names})")
    return n


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

    def dispatch_shape(T, wr=wr, K=K):
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
        print(f"gating_dispatch {r['shape']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms; idx_buf and "
              f"counts identical, gates max |err| {r['err']:.3e}, two launches "
              f"bit-identical; smallest top-{K} probability margin {margin:.3e}")
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

    # -- gating_topk on the same router inputs: experts and counts exact,
    # gates f32 sums -> 1e-5
    got, want = kops.gating_topk(x, wr, K), gating_topk_plain(x, wr, K)
    torch.cuda.synchronize()
    check_topk(torch, "gating_topk bf16", got, want)
    g3 = kops.gating_topk(xs, ws, 3)
    check_topk(torch, "gating_topk f32", g3, gating_topk_plain(xs, ws, 3))
    print(f"gating_topk x {tuple(x.shape)} top-{K}: experts and counts identical, "
          f"gates max |err| {max_err(torch, got[0], want[0]):.3e}")

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
    del big, dst, w1, w2, w3, xe, he
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


def registry_kernel_shapes(torch, dev, gen, flush, randn, rows, attn_shape,
                           dispatch_shape, gm_shape):
    """Phase 1 at the shapes phase 7's models give the three serving
    kernels, each held against its plain version and timed (appended to
    the kernels' ``shapes``): decode attention in bf16 at head_dim 256
    with rep 10 over a wrapped 2048-slot ring (recurrentgemma-2b's local
    layers), head_dim 128 with rep 2 and softcap 50 (gemma2-27b) and
    head_dim 64 with rep 1 (whisper-large-v3), the paged kernel at head
    dim 256; gating dispatch at 60 experts top-4, d 2048 (qwen2-moe) and
    128 experts top-2, d 7168 (arctic) for T = 4 and 8; the grouped
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
            r, _ = dispatch_shape(T, wr=wr, K=K)
            r["model"] = model
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
    phase_placement_parity(torch, dev, cfg, params)


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


def registry_params(torch, cfg, dtype, dev):
    """Random weights from seed 0; the llama-3.2-vision cross layers'
    tanh gates (0 at init, which makes each cross layer the identity)
    opened to 0.5 so the cross path does work."""
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
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
    gd = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "gating_dispatch" in e.name]
    gd_kernels = len(gd)
    print(f"{label}: gating_dispatch {calls} calls, {gd_kernels} device kernels, "
          f"{sum(gd) / max(1, gd_kernels):.2f} us each")
    require(calls > 0 and gd_kernels == calls,
            f"{label}: {gd_kernels} gating_dispatch kernels for {calls} calls")
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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
        phase_f32_parity(torch, dev, cfg)
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, n_layers=MAIN["n_layers"])
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        launches, stages = phase_bf16_serving(torch, dev, cfg, params)
        for name in launches.keys() & rows.keys():
            rows[name]["launches"] = launches[name]
        planner_line(torch, cfg, stages)
        rows.update(phase_paged_serving(torch, dev, cfg, params))
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
        t_end = time.perf_counter()
        for name in ("decode_attention", "gating_dispatch", "grouped_matmul"):
            for sh in rows[name]["shapes"]:
                if "model" in sh:
                    sh["path_launches"] = path_launches[sh["model"]][name]
        kernels = []
        for name in ("decode_attention", "paged_decode_attention", "gating_topk",
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
            if "shapes" in r:
                kernels[-1]["shapes"] = [
                    {"shape": sh["shape"], "max_abs_err": sh["err"], "ms": sh["ms"],
                     "plain_ms": sh["plain_ms"], "bound_ms": sh["bound"][0],
                     "bound_by": sh["bound"][1], "library_ms": sh["library_ms"],
                     **{k: sh[k] for k in ("fma_ms", "mma_ms", "model", "path_launches")
                        if k in sh}}
                    for sh in r["shapes"]]
        require({Path(k["source"]).name for k in kernels} == set(REGISTRY),
                "a registered kernel has no row")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: phases 1-7 in {t8 - t_start:.1f} s (the build included), "
          f"phase 8 in {t_end - t8:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
