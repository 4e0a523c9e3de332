"""One run of one cell: set-up, the measured window, the traced stretch,
the per-layer readings and the check of the served tokens.

``measure`` takes the device as an argument so that the tests can drive
the whole run on the CPU at a tiny size; ``run.py`` is the entry point
that looks for the card first.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from harness import check as check_lib
from harness import spec as spec_lib
from harness import trace as trace_lib
from harness import window as window_lib
from harness.serve import ClosedLoop, build_engine, positions_array, window_records
from harness.traffic import Traffic
from harness.weights import Layout, Redraw, draw

GIB = 2 ** 30


class Run:
    """What a per-layer metric reader is handed (``read(run)``)."""

    def __init__(self, config: dict, loop: ClosedLoop, steps, window_s: float,
                 stages: Optional[dict], mb_slices, max_batch: int,
                 trace: Optional[trace_lib.Trace], works: Dict[str, object]):
        self.config = config
        self.all_steps = loop.steps
        self.steps = steps
        self.window_s = window_s
        self.stages = stages
        L = config["num_hidden_layers"]
        self.decode_iters = ((stages or {}).get("expert_n", 0)
                             / (L * max(1, len(mb_slices or [None]))))
        self.mb_slices = mb_slices
        self.max_batch = max_batch
        self.trace = trace
        self.works = works

    def step_rows(self, index: int) -> np.ndarray:
        return positions_array(self.all_steps[index], self.max_batch)

    def roofline(self, kernel: str) -> Optional[float]:
        return trace_lib.roofline(self.trace, self.works[kernel], self,
                                  self.config["torch_dtype"])


def _say(*a):
    print(*a, file=sys.stderr, flush=True)


def measure(cell: spec_lib.Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_proc: Optional[float] = None,
            after_window: Optional[Callable] = None) -> dict:
    """One run.  Returns the result's fields (without ``device``), plus
    ``readings`` for the caller; ``after_window(loop, ctx)`` runs once the
    program's state is freed, before the check (the control's hook)."""
    import torch
    clock = time.perf_counter
    t_proc = clock() if t_proc is None else t_proc
    phases = {"start": clock() - t_proc}
    cfg_file, traffic_spec = cell.config, cell.traffic
    eng_spec = traffic_spec["engine"]
    cuda = torch.device(device).type == "cuda"

    t = clock()
    layout = Layout(cfg_file)
    params, flats = draw(layout, seed, device)
    if cuda:
        torch.cuda.synchronize()
    phases["draw_weights"] = clock() - t

    t = clock()
    eng, _ = build_engine(cfg_file, eng_spec, params, device)
    phases["build_engine"] = clock() - t
    readers = spec_lib.metric_readers([m["name"] for m in cell.per_layer]) if trace else {}
    rec = trace_lib.Recorder()
    works = {k: spec_lib.work_module(k) for k in spec_lib.kernels_of(readers)}
    for w in works.values():
        w.install(rec)

    traffic = Traffic(traffic_spec, seed, cfg_file["vocab_size"])
    loop = ClosedLoop(eng, traffic, clock=clock)
    loop.before_step = lambda i: rec.log.append(("step", i)) if rec.on else None
    t = clock()
    loop.start()
    loop.step()                       # admits every client: the in-flight start
    phases["admit_start"] = clock() - t
    t = clock()
    for _ in range(int(traffic_spec["warm_steps"])):
        loop.refill()
        loop.step()
    if cuda:
        torch.cuda.synchronize()
    phases["warm_steps"] = clock() - t
    stretch = trace_lib.Stretch(torch, rec) if trace else None
    if stretch is not None and cuda:
        stretch.warm()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    runtime = eng.runtime
    if runtime is not None:
        runtime.reset_stage_times()
    setup_s = clock() - t_proc

    # ---- the measured window
    stretch_at, stretch_len = 0.4 * seconds, min(3.0, 0.25 * seconds)
    t_start = clock()
    loop.refill()
    while True:
        now = clock()
        if stretch is not None and stretch.prof is None and now - t_start >= stretch_at:
            stretch.open()
        open_ = stretch is not None and stretch.prof is not None and stretch.t1 is None
        label = trace_lib.LABEL_ADMIT if eng.waiting else trace_lib.LABEL_STEP
        with (torch.profiler.record_function(label) if open_
              else contextlib.nullcontext()):
            last = loop.step(traced=open_)
        if open_ and clock() - stretch.t0 >= stretch_len:
            stretch.close()
        if last.t1 - t_start >= seconds:
            break
        loop.refill()
    if stretch is not None and stretch.prof is not None and stretch.t1 is None:
        stretch.close()
    t_end = last.t1
    rec.restore()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    stages = runtime.stage_report() if runtime is not None else None
    steps, flights = window_records(loop, t_start, t_end)
    counts = window_lib.counts(steps, flights, t_start, t_end)
    metrics: Dict[str, float] = {}
    breakdown, dev_extra = None, {}
    if trace:
        tr = trace_lib.Trace(stretch, rec) if stretch is not None and stretch.prof else None
        run = Run(cfg_file, loop, steps, t_end - t_start, stages,
                  getattr(eng, "mb_slices", None), eng.max_batch, tr, works)
        for name, mod in readers.items():
            v = mod.read(run)
            if v is not None:
                metrics[name] = float(v)
        if tr is not None:
            dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
            breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
            for k, w in works.items():
                s, n = tr.kernel_seconds(w.KERNEL_NAMES)
                _say(f"trace {k}: {n} device kernels, {s * 1e3:.3f} ms; "
                     f"{sum(1 for r in tr.log if r[0] == k)} launches recorded")
            _say(f"trace stretch {tr.window_s:.3f} s, device busy {tr.busy_s:.3f} s, "
                 f"{len(tr.device)} device / {len(tr.host)} host events")
    else:
        metrics.update(window_lib.end_to_end(steps, flights, t_start, t_end))
        metrics["peak_mem_gib"] = window_peak / GIB
        metrics["setup_s"] = setup_s
    vocab = cfg_file["vocab_size"]
    attempted = sum(1 for f in flights if f.t_submit >= t_start)
    failed = check_lib.malformed([f for f in flights if f.t_submit >= t_start], vocab)
    n_groups = len(getattr(eng, "mb_slices", None) or [None])
    group_of = (eng.slots.group_of if n_groups > 1 else (lambda slot: 0))
    picked = check_lib.sample(check_lib.window_requests(flights, t_start, t_end),
                              seed, group_of, n_groups,
                              cell.check.get("sample_tokens", 1024),
                              cell.check.get("per_group", 2))
    _say(f"window {t_end - t_start:.3f} s: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()) + f"; attempted {attempted}")
    _say("window readings " + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()))
    _say("setup " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
         + f"; setup_s {setup_s:.3f}")
    if stages is not None:
        _say("stages " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(stages.items())
                                    if isinstance(v, (int, float))))

    # ---- free the program's state, then the check
    del eng, runtime, params, flats
    loop.eng = None
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ref = spec_lib.reference_module(cfg_file["reference"])
    w = Redraw(layout, seed, device)
    t = clock()
    ref_logits = ref.logits(w, cfg_file, check_lib.sequences(picked), device)
    gaps = check_lib.gaps_of(torch, ref_logits, picked)
    readings = check_lib.summary(gaps)
    ctx = {"torch": torch, "ref": ref, "weights": w, "picked": picked,
           "ref_logits": ref_logits, "gaps": gaps, "device": device,
           "config": cfg_file}
    if after_window is not None:
        after_window(loop, ctx)
    w.release()
    del ref_logits, ctx
    if cuda:
        torch.cuda.synchronize()
    check_s = clock() - t
    limits = cell.check.get("limits", {})
    correct = (bool(picked) and failed == 0
               and check_lib.verdict(readings, limits))
    _say(f"check: {len(picked)} requests, {int(gaps.size)} served tokens, "
         f"reference {check_s:.3f} s; " + ", ".join(
             f"{k} {v:.6g}" for k, v in readings.items()))
    check_out = {k: {"value": readings.get(k, float("inf")), "limit": lim}
                 for k, lim in limits.items()}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "breakdown": breakdown, "check": check_out,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "device_extra": dev_extra, "setup_phases": phases,
            "readings": readings, "gaps": gaps, "window": counts,
            "sampled": [(f.k, len(f.req.prompt), len(f.req.generated)) for f in picked]}
