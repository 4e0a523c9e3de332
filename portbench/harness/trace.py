"""The traced run's device record: a ``torch.profiler`` stretch of whole
engine steps inside the window, and the launches of the kernels whose
rooflines the cell reports, recorded at the calls into them.

A kernel's work count (``portbench/work/<kernel>.py``) wraps the port's
kernel entry points while the stretch is open (``install``) and turns
what it recorded into each launch's needed FLOPs and bytes (``need``);
its ``KERNEL_NAMES`` pick its device kernels out of the trace.  The
roofline share is the summed least time of the needed work over the
summed device time of those kernels, both over the stretch.

Busy time is the union of every device activity's span (kernels,
copies, sets) on every stream; the idle gaps between them are put down
to what the host was doing at their middle: the step's kind and the
innermost host operation then open.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from harness import peaks

LABEL_ADMIT = "portbench.step+admit"
LABEL_STEP = "portbench.step"


class Recorder:
    """The log the work counts append to while ``on``; the closed loop puts a
    ("step", index) marker before each traced step."""

    def __init__(self):
        self.on = False
        self.log: List[tuple] = []
        self._undo: List[tuple] = []

    def patch(self, module, name: str, make):
        """Replace ``module.name`` by ``make(original)`` until ``restore``."""
        orig = getattr(module, name)
        self._undo.append((module, name, orig))
        setattr(module, name, make(orig))

    def restore(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()


class Stretch:
    """Opens and closes the profiler around whole steps."""

    def __init__(self, torch, recorder: Recorder):
        self.torch = torch
        self.rec = recorder
        self.prof = None
        self.t0 = self.t1 = None

    def warm(self):
        """A throwaway profile, so the profiler's own start-up (seconds)
        falls in set-up and not in the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            self.torch.ones(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def open(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.rec.on = True
        self.t0 = time.perf_counter()

    def close(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.rec.on = False
        self.prof.stop()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def events(prof) -> Tuple[List[tuple], List[tuple]]:
    """(device events, host events) of a profile, each (name, start ns,
    end ns), sorted by start.  A host range the profiler also draws on the
    device's timeline (a ``record_function`` label) is host activity."""
    import torch
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and e.is_user_annotation():
            continue
        s = e.start_ns()
        rec = (e.name(), s, s + e.duration_ns())
        (dev if e.device_type() == cuda else host).append(rec)
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return dev, host


def union(spans: List[tuple]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for _, s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """What the stretch saw."""

    def __init__(self, stretch: Stretch, recorder: Recorder):
        self.window_s = stretch.seconds
        self.device, self.host = events(stretch.prof)
        self.log = recorder.log
        self.busy = union(self.device)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        self._starts = [h[1] for h in self.host]
        self._labels = [h for h in self.host if h[0] in (LABEL_ADMIT, LABEL_STEP)]
        self._label_starts = [h[1] for h in self._labels]

    def kernel_seconds(self, names) -> Tuple[float, int]:
        """Summed device time and count of the kernels whose name holds
        one of ``names``."""
        durs = [e - s for n, s, e in self.device if any(k in n for k in names)]
        return sum(durs) / 1e9, len(durs)

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            by[name[:160]] += (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device activity, summed by what the host was
        doing at each gap's middle."""
        by: Dict[str, float] = defaultdict(float)
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            by[self._host_at((e0 + s1) // 2)] += (s1 - e0) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: int, look: int = 400) -> str:
        j = bisect.bisect_right(self._label_starts, t) - 1
        label = (self._labels[j][0] if j >= 0 and self._labels[j][2] >= t
                 else "between steps")
        i = bisect.bisect_right(self._starts, t)
        inner, inner_len = None, None
        for name, s, e in self.host[max(0, i - look):i]:
            if e >= t and name not in (LABEL_ADMIT, LABEL_STEP) and (
                    inner_len is None or e - s < inner_len):
                inner, inner_len = name, e - s
        return f"{label}: {inner or 'python'}"[:160]


def roofline(trace: Optional[Trace], work, run, dtype: str) -> Optional[float]:
    """100 x (least time of the needed work) / (the kernels' device time),
    over the stretch; None where the stretch launched none of them."""
    if trace is None:
        return None
    needs = work.need(trace.log, run)
    dev_s, n = trace.kernel_seconds(work.KERNEL_NAMES)
    if not needs or not n or dev_s <= 0:
        return None
    bound = sum(peaks.bound_s(f, b, dtype) for f, b in needs)
    return 100.0 * bound / dev_s
