"""Engine layer (``serving/engine.py``): the cost of one inline admission
(prefill and KV insert) per request: the summed wall time of the steps
that admitted anyone, less as many plain decode steps
(``engine.decode_step_ms``), over the requests they admitted.  Steps
inside the profiled stretch are left out."""

UNIT = "ms"


def read(run):
    plain = [s.t1 - s.t0 for s in run.steps if not s.admitted and not s.traced]
    admit = [s for s in run.steps if s.admitted and not s.traced]
    n = sum(len(s.admitted) for s in admit)
    if not plain or not n:
        return None
    step = sum(plain) / len(plain)
    return 1e3 * (sum(s.t1 - s.t0 for s in admit) - len(admit) * step) / n
