"""The window's arithmetic: rates over the whole window, tails over all
samples, and the engine layer's readings from synthetic spans."""
import types

import numpy as np
import portbench_tiny  # noqa: F401
import pytest
from harness import check, window
from harness.serve import Step
from harness.spec import metric_readers


def flight(t_submit, times):
    return types.SimpleNamespace(t_submit=t_submit, times=list(times))


def steps_of(walls, admitted=None):
    out, t = [], 0.0
    for i, w in enumerate(walls):
        adm = (admitted or {}).get(i, [])
        out.append(Step(t0=t, t1=t + w, admitted=adm, rows={0: 10}, tokens=2))
        t += w
    return out


def test_rate_is_over_the_whole_window():
    steps = steps_of([0.1] * 10)
    fl = [flight(0.0, [s.t1 for s in steps])]
    m = window.end_to_end(steps, fl, 0.0, 2.0)      # the window is 2 s long
    assert m["output_tok_s"] == pytest.approx(20 / 2.0)


def test_p95_is_over_all_samples_and_moves_with_one_stall():
    """One stalled step of 2 s hits all 20 requests in flight at once: in a
    window of 420 gaps those 20 stay under the 95th percentile, in a window
    of 200 they move it."""
    times = [0.05 * i for i in range(1, 12)]
    fl = [flight(0.0, times) for _ in range(20)]
    base = window.percentile(window.token_gaps(fl, 0.0, 10.0), 95)
    assert base == pytest.approx(0.05)
    stalled = times[:6] + [t + 2.0 for t in times[6:]]
    fl = [flight(0.0, stalled + [stalled[-1] + 0.05 * i for i in range(1, 12)])
          for _ in range(20)]
    gaps = window.token_gaps(fl, 0.0, 10.0)
    assert len(gaps) == 20 * 21
    assert window.percentile(gaps, 95) == pytest.approx(float(np.percentile(gaps, 95)))
    assert window.percentile(gaps, 95) == pytest.approx(0.05)       # 20 of 420: under 5%
    short = [flight(0.0, stalled) for _ in range(20)]     # 20 of 200: 10%
    assert window.percentile(window.token_gaps(short, 0.0, 10.0), 95) > 1.0


def test_ttft_counts_requests_submitted_in_the_window():
    fl = [flight(-1.0, [0.5, 0.6]), flight(0.2, [0.5, 0.6]), flight(0.3, [0.45])]
    assert sorted(window.ttfts(fl, 0.0, 1.0)) == pytest.approx([0.15, 0.3])


def test_gaps_inside_the_window_only():
    fl = [flight(0.0, [0.5, 1.0, 1.5, 2.5])]
    assert window.token_gaps(fl, 0.9, 2.0) == pytest.approx([0.5, 0.5])


def test_engine_spans():
    r = metric_readers(["engine.decode_step_ms", "engine.admit_ms"])
    steps = steps_of([0.040, 0.040, 0.070, 0.040, 0.100, 0.040],
                     admitted={2: [300], 4: [250, 400]})
    steps[5].traced = True
    steps[5].t1 += 1.0                                  # profiled: left out
    run = types.SimpleNamespace(steps=steps)
    assert r["engine.decode_step_ms"].read(run) == pytest.approx(40.0)
    # (0.07 + 0.10 - 2 x 0.04) / 3 requests
    assert r["engine.admit_ms"].read(run) == pytest.approx(30.0)
    assert r["engine.admit_ms"].read(types.SimpleNamespace(steps=steps[:2])) is None


def test_runtime_and_idle_readers():
    r = metric_readers(["runtime.expert_ms", "runtime.attn_ms", "device.idle_share"])
    run = types.SimpleNamespace(
        stages={"expert_s": 2.0, "expert_n": 160, "attn_s": 0.3, "attn_n": 160,
                "combine_s": 0.1}, decode_iters=10,
        trace=types.SimpleNamespace(window_s=2.0, busy_s=1.5))
    assert r["runtime.expert_ms"].read(run) == pytest.approx(200.0)
    assert r["runtime.attn_ms"].read(run) == pytest.approx(40.0)
    assert r["device.idle_share"].read(run) == pytest.approx(25.0)
    run.trace = None
    assert r["device.idle_share"].read(run) is None


def test_check_samples_requests_still_running_at_the_close():
    """The check's candidates are the window's submissions that were
    served a token, finished or not: the longest is one still running."""
    def f(k, t_submit, times, done, n):
        return types.SimpleNamespace(k=k, t_submit=t_submit, times=list(times),
                                     slot=k % 2, req=types.SimpleNamespace(
                                         done=done, generated=list(range(n))))
    fl = [f(0, -1.0, [0.5, 0.6], True, 2),          # submitted before the window
          f(1, 0.1, [0.3, 0.4], True, 2),            # finished in it
          f(2, 0.2, [0.3, 0.4, 0.9], False, 3),      # still running at its close
          f(3, 0.8, [], False, 0),                   # waiting: nothing served
          f(4, 0.5, [0.95, 1.0], False, 40)]         # running, the longest
    cands = check.window_requests(fl, 0.0, 1.0)
    assert [c.k for c in cands] == [1, 2, 4]
    picked = check.sample(cands, 7, lambda slot: slot, 2, sample_tokens=1, per_group=1)
    assert picked[0].k == 4 and {c.k for c in picked} >= {4, 1}
