"""The readers of the port's own spans and stream-stall counters, on
synthetic traces and stage reports: the device busy time clipped to the
admission spans, the division by the requests they admitted, the mean
span walls, the stalls per decode iteration, and nothing read where the
spans or keys are absent (a program without them)."""
import types

import portbench_tiny  # noqa: F401
import pytest
from harness.spec import metric_readers

NAMES = ["engine.admit_device_ms", "model.prefill_issue_ms",
         "engine.decode_issue_ms", "runtime.attn_wait_ms",
         "runtime.expert_wait_ms"]
MS = 1_000_000                                    # ns


@pytest.fixture(scope="module")
def r():
    return metric_readers(NAMES)


def trace_of(host, busy):
    return types.SimpleNamespace(host=sorted(host, key=lambda h: h[1]), busy=busy)


def test_admit_device_time_is_the_busy_union_inside_admitting_spans(r):
    host = [("engine.admit", 0, 10 * MS),            # admits 2 requests
            ("engine.admit.insert", 2 * MS, 3 * MS),
            ("engine.admit.insert", 6 * MS, 7 * MS),
            ("model.prefill", 1 * MS, 2 * MS),
            ("engine.admit", 20 * MS, 21 * MS),       # admits nobody
            ("engine.admit", 30 * MS, 40 * MS),       # admits 1
            ("engine.admit.insert", 35 * MS, 36 * MS)]
    busy = [(-5 * MS, 1 * MS),          # 1 ms of it inside the first span
            (4 * MS, 8 * MS),           # 4 ms
            (20 * MS, 21 * MS),         # inside the span that admitted nobody
            (39 * MS, 45 * MS)]         # 1 ms inside the third
    run = types.SimpleNamespace(trace=trace_of(host, busy))
    # (1 + 4 + 1) ms over 3 requests
    assert r["engine.admit_device_ms"].read(run) == pytest.approx(2.0)


def test_admit_device_time_needs_admissions(r):
    read = r["engine.admit_device_ms"].read
    assert read(types.SimpleNamespace(trace=None)) is None
    no_spans = trace_of([("portbench.step", 0, 10 * MS)], [(0, 10 * MS)])
    assert read(types.SimpleNamespace(trace=no_spans)) is None
    nobody = trace_of([("engine.admit", 0, 10 * MS)], [(0, 10 * MS)])
    assert read(types.SimpleNamespace(trace=nobody)) is None


@pytest.mark.parametrize("name,span", [("model.prefill_issue_ms", "model.prefill"),
                                       ("engine.decode_issue_ms",
                                        "engine.decode.issue")])
def test_issue_spans_mean_wall(r, name, span):
    host = [(span, 0, 4 * MS), (span, 10 * MS, 12 * MS), ("engine.step", 0, 20 * MS)]
    run = types.SimpleNamespace(trace=trace_of(host, []))
    assert r[name].read(run) == pytest.approx(3.0)
    run.trace = trace_of([("engine.step", 0, 20 * MS)], [])
    assert r[name].read(run) is None
    run.trace = None
    assert r[name].read(run) is None


@pytest.mark.parametrize("name,key", [("runtime.attn_wait_ms", "n2m_wait_s"),
                                      ("runtime.expert_wait_ms", "m2n_wait_s")])
def test_stream_stalls_per_decode_iteration(r, name, key):
    run = types.SimpleNamespace(stages={key: 0.5, "expert_n": 160}, decode_iters=10)
    assert r[name].read(run) == pytest.approx(50.0)
    run.stages = {"expert_n": 160, "expert_s": 2.0}          # a program without it
    assert r[name].read(run) is None
    run.stages, run.decode_iters = {key: 0.5}, 0
    assert r[name].read(run) is None
    run.stages = None
    assert r[name].read(run) is None
