#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all at once, into ``build/repro_torch_kernels``),
then:

  1. holds each kernel against its plain PyTorch version on the card, at
     the serving path's shapes in bf16 and at small f32 shapes (decode
     attention also at phase 2's monolithic shape), and times kernel,
     plain version and the nearest single PyTorch call;
  2. serves mixtral-8x22b at full width (2 layers, f32 weights, TF32
     off) in ``pingpong`` (m = 2) and ``monolithic`` mode on the same
     requests, each run with the launch counts set to 0 just before and
     read just after, and requires identical greedy tokens, decode
     attention launched by both paths and the MoE kernels by ping-pong
     only;
  3. serves mixtral-8x22b at full width (4 layers, bf16 weights, f32
     router) through the ``pingpong`` engine (max_batch 8, m = 2, 64 new
     tokens per request), with the kernel launch counts set to 0 just
     before and read just after, and requires every request to finish
     and every kernel to have run.  It prints the serve rate (prefill
     included) and the decode rate (decode tokens over the engine's
     decode phase time).

Before the last line it prints the card's name and power limit and a
``{"kernels": [...]}`` line; the last line is the contract line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
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
           prompt_len=12, max_new=4, n_layers=2)


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


def time_ms(torch, fn, reps=20, flush=None):
    """Median device time of one call, each call timed with its own CUDA
    events; ``flush`` (a large buffer) is rewritten before every call so
    the call finds its inputs outside L2, as in the decode step."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


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


# ----------------------------------------------------------------- phase 1
def phase_kernels(torch, dev):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.gating_dispatch import gating_dispatch_plain
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.attention import decode_attention as attn_plain
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(dtype)

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
    err = max_err(torch, got, want)
    mask = ((cpos >= 0) & (cpos <= pos[:, None]))[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    valid = int(((cpos >= 0) & (cpos <= pos[:, None])).sum())
    nbytes = (2 * q.numel() * 2 + valid * Hkv * hd * 2 * 2 + cpos.numel() * 4
              + pos.numel() * 4)
    flops = 4 * valid * H * hd
    rows["decode_attention"] = dict(
        err=err,
        ms=time_ms(torch, lambda: kops.decode_attention(*args), flush=flush),
        plain_ms=time_ms(torch, lambda: attn_plain(*args), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush),
        bound=bound_ms(nbytes, flops, "bfloat16"),
        replaces="src/repro/kernels/decode_attention.py:85")
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

    # -- gating_dispatch: one micro-batch of router inputs (T = 4 tokens,
    # d 6144, 8 experts, top-2, capacity C = T in capacity_mode "full")
    T, d, E, K = B, 6144, 8, 2
    x = randn(T, d)
    wr = randn(d, E, dtype=torch.float32, scale=d ** -0.5)
    cw = torch.ones(T, device=dev)
    bias = torch.zeros(E, device=dev)
    gk = dict(bias=bias, count_weights=cw)
    got = kops.gating_dispatch(x, wr, K, E, T, **gk)
    want = gating_dispatch_plain(x, wr, K, E, T, **gk)
    torch.cuda.synchronize()
    probs = moe_lib.route(x, wr, K).probs.sort(dim=-1, descending=True).values
    margin = float((probs[:, K - 1] - probs[:, K]).min())
    print(f"gating_dispatch: smallest top-{K} probability margin of the inputs "
          f"{margin:.3e}")
    # the slot build must be identical; gates are f32 sums -> 1e-5
    require(torch.equal(got[0], want[0]), "gating_dispatch bf16: idx_buf differs")
    require(torch.equal(got[2], want[2]), "gating_dispatch bf16: counts differ")
    check_close(torch, "gating_dispatch gates", got[1], want[1], 1e-5, 1e-5)
    nbytes = (x.numel() * 2 + wr.numel() * 4 + 4 * E + 4 * T
              + 2 * E * T * 4 + E * 4)
    rows["gating_dispatch"] = dict(
        err=max_err(torch, got[1], want[1]),
        ms=time_ms(torch, lambda: kops.gating_dispatch(x, wr, K, E, T, **gk),
                   flush=flush),
        plain_ms=time_ms(torch, lambda: gating_dispatch_plain(x, wr, K, E, T, **gk),
                         flush=flush),
        library_ms=None,
        bound=bound_ms(nbytes, 2 * T * d * E, "float32"),
        replaces="src/repro/kernels/gating_topk.py:255")
    # f32 small shape with drops, bias and weights (T*K = 256 >> E*C = 32)
    xs = randn(128, 32, dtype=torch.float32)
    ws = randn(32, 4, dtype=torch.float32)
    kw = dict(bias=torch.linspace(-1, 1, 4, device=dev),
              count_weights=(torch.arange(128, device=dev) % 2).float())
    g2, w2 = kops.gating_dispatch(xs, ws, 2, 4, 8, **kw), \
        gating_dispatch_plain(xs, ws, 2, 4, 8, **kw)
    require(torch.equal(g2[0], w2[0]) and torch.equal(g2[2], w2[2]),
            "gating_dispatch f32: idx_buf or counts differ")

    # -- grouped_matmul: the expert phase's first GEMM for one micro-batch
    # (8 experts, M = C = 4 rows, 6144 -> 16384) in bf16
    G, M, N = E, T, 16384
    xe = randn(G, M, d)
    w1 = randn(G, d, N, scale=d ** -0.5)
    got, want = kops.grouped_matmul(xe, w1), grouped_matmul_plain(xe, w1)
    torch.cuda.synchronize()
    check_close(torch, "grouped_matmul bf16", got, want, 2e-2, 2e-2)
    rows["grouped_matmul"] = dict(
        err=max_err(torch, got, want),
        ms=time_ms(torch, lambda: kops.grouped_matmul(xe, w1)),
        plain_ms=time_ms(torch, lambda: grouped_matmul_plain(xe, w1), reps=5),
        library_ms=time_ms(torch, lambda: torch.bmm(xe, w1)),
        bound=bound_ms((xe.numel() + w1.numel() + G * M * N) * 2,
                       2 * G * M * d * N, "bfloat16"),
        replaces="src/repro/kernels/grouped_matmul.py:56")
    for shape in ((3, 17, 130, 257), (2, 1, 64, 8)):
        g_, m_, k_, n_ = shape
        a_, b_ = randn(g_, m_, k_, dtype=torch.float32), randn(
            g_, k_, n_, dtype=torch.float32)
        # f32: f32 FMA against f32 einsum, another summation order -> 1e-4
        check_close(torch, f"grouped_matmul f32 {shape}",
                    kops.grouped_matmul(a_, b_), grouped_matmul_plain(a_, b_),
                    1e-4, 1e-4)

    # -- the composed grouped MLP against the card's copy bandwidth; the
    # down projection (N = d = 6144) is timed on its own
    w3, w2 = randn(G, d, N, scale=d ** -0.5), randn(G, N, d, scale=N ** -0.5)
    he = randn(G, M, N)
    down_ms = time_ms(torch, lambda: kops.grouped_matmul(he, w2))
    down_bmm = time_ms(torch, lambda: torch.bmm(he, w2))
    print(f"grouped_matmul down projection {tuple(he.shape)} @ {tuple(w2.shape)}: "
          f"{down_ms:.4f} ms, torch.bmm {down_bmm:.4f} ms, bound "
          f"{w2.numel() * 2 / PEAK_BYTES_S * 1e3:.4f} ms")
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
    del big, dst, flush, w1, w2, w3, xe, he
    return rows


# ----------------------------------------------------------------- phases 2, 3
def build_engines(torch, cfg, params, spec, runtimes):
    from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import Engine
    out = {}
    for rt in runtimes:
        sc = ServingConfig(max_batch=spec["max_batch"], max_seq=spec["max_seq"],
                           runtime=rt, microbatches=spec["microbatches"],
                           verbose=False)
        inst = (DisaggregatedInstance(cfg, params, DisaggPlan(sc.microbatches))
                if rt == "pingpong" else None)
        out[rt] = Engine(cfg, params, config=sc, runtime=inst)
    return out


def serve(torch, eng, prompts, max_new):
    from repro_torch.serving.engine import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=max_new))
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    return {r.rid: list(r.generated) for r in eng.finished}, time.perf_counter() - t0


def prompts_for(spec, vocab, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=spec["prompt_len"]).tolist()
            for _ in range(spec["n_requests"])]


def phase_f32_parity(torch, dev, base_cfg):
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(base_cfg, n_layers=F32["n_layers"])
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    engines = build_engines(torch, cfg, params, F32, ("pingpong", "monolithic"))
    prompts = prompts_for(F32, cfg.vocab)
    toks, launches = {}, {}
    for rt, eng in engines.items():
        reset_launch_counts()
        toks[rt] = serve(torch, eng, prompts, F32["max_new"])[0]
        launches[rt] = launch_counts()
    require(len(toks["pingpong"]) == F32["n_requests"], "f32: requests unfinished")
    require(toks["pingpong"] == toks["monolithic"],
            f"f32: pingpong tokens {toks['pingpong']} != monolithic "
            f"{toks['monolithic']}")
    # the monolithic path runs decode attention on its kernel and the MoE
    # layer in plain torch; the ping-pong path runs all three kernels
    mono, pp = launches["monolithic"], launches["pingpong"]
    require(mono["decode_attention"] > 0,
            "f32: decode_attention was not launched on the monolithic path")
    require(mono["gating_dispatch"] == 0 and mono["grouped_matmul"] == 0,
            f"f32: the monolithic path launched MoE kernels: {mono}")
    for name, n in pp.items():
        require(n > 0, f"f32: kernel {name} was not launched on the pingpong path")
    print(f"phase 2 (f32, {cfg.n_layers} layers, full width): pingpong == "
          f"monolithic greedy tokens for {len(prompts)} requests "
          f"({sum(map(len, toks['pingpong'].values()))} tokens)")
    for rt, counts in launches.items():
        print(f"phase 2 launches [{rt}]: "
              + " ".join(f"{k}={v}" for k, v in counts.items()))


def phase_bf16_serving(torch, dev, base_cfg):
    from repro_torch.kernels.cuda_build import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import decode_step, init_params, prefill
    from repro_torch.serving.engine import Request
    cfg = dataclasses.replace(base_cfg, n_layers=MAIN["n_layers"])
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"]]
                   + [v for lp in params["layers"] for v in lp.values()])
    eng = build_engines(torch, cfg, params, MAIN, ("pingpong",))["pingpong"]
    inst = eng.runtime

    # in-situ check: one ping-pong decode step against the monolithic
    # decode_step on copies of one prefilled cache.  bf16 weights and
    # activations round at different places in the two paths -> logits
    # within 5% of their range, and finite
    toks = torch.randint(2, cfg.vocab, (MAIN["max_batch"], MAIN["prompt_len"]),
                         device=dev, generator=torch.Generator(dev).manual_seed(1))
    _, c_ref = prefill(params, cfg, toks, max_seq=MAIN["max_seq"])
    c_pp = [{k: v.clone() for k, v in e.items()} for e in c_ref]
    pos = torch.full((MAIN["max_batch"],), MAIN["prompt_len"], dtype=torch.int32,
                     device=dev)
    want, _ = decode_step(params, cfg, toks[:, -1], c_ref, pos)
    got, _ = inst.decode_microbatched(toks[:, -1], c_pp, pos, eng.mb_slices)
    require(bool(torch.isfinite(got).all()), "bf16: non-finite logits")
    rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    require(rel < 5e-2, f"bf16: pingpong logits differ from monolithic by {rel:.3e}")
    print(f"phase 3 check: bf16 pingpong vs monolithic logits max rel diff "
          f"{rel:.3e}, argmax agreement {agree:.2f}")
    del c_ref, c_pp

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
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
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
        f"{k}={v} ({v / max(1, iters):.1f}/decode iter)" for k, v in launches.items())
        + f" over {iters} iters; prefill runs plain torch")
    profile_decode(torch, eng, prompts_for(MAIN, cfg.vocab, seed=2))
    return launches


def profile_decode(torch, eng, prompts):
    """Trace three decode iterations of a full batch with torch.profiler:
    the device's busy share of the window (union of kernel intervals on
    both streams) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=100 + i, prompt=list(p), max_new_tokens=6))
    eng.step()                        # admission and prefill stay outside
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run_until_done()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("profile: the profiler recorded no device time")
        return
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    print(f"profile: 3 decode iters in {wall_us / 1e3:.2f} ms wall, device busy "
          f"{busy / 1e3:.2f} ms = {busy / wall_us:.3f} of the window "
          f"({len(spans)} device ops)")
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile:   {us / 1e3:8.3f} ms  {name[:90]}")


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

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    try:
        t0 = time.perf_counter()
        libs = build_all()
        print(f"built {len(libs)} kernel libraries in "
              f"{time.perf_counter() - t0:.1f} s")
        for src, lib in sorted(libs.items()):
            log = lib.with_suffix(".log")
            used = [ln.strip() for ln in (log.read_text().splitlines()
                                          if log.exists() else [])
                    if "Used" in ln]
            print(f"  {src}: " + ("; ".join(used) or "cached build"))
        rows = phase_kernels(torch, dev)
        cfg = get_config("mixtral-8x22b")
        phase_f32_parity(torch, dev, cfg)
        torch.cuda.empty_cache()
        launches = phase_bf16_serving(torch, dev, cfg)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, r in rows.items():
        src = f"{name}.cu"
        require(src in REGISTRY, f"{src} not registered")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
