"""Engine layer (``serving/engine.py``): mean host wall time of the
window's ``Engine.step()`` calls that admitted nobody, from the
benchmark's own step spans (each ends in the engine's wait for the
sampled tokens).  Steps inside the profiled stretch are left out."""

UNIT = "ms"


def read(run):
    walls = [s.t1 - s.t0 for s in run.steps if not s.admitted and not s.traced]
    return 1e3 * sum(walls) / len(walls) if walls else None
