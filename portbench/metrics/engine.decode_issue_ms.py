"""Engine layer (``serving/engine.py``): mean host wall time of the
``engine.decode.issue`` spans in the profiled stretch: building a decode
step's inputs and issuing every micro-batch and layer of it, up to the
runtime's return (before the wait for its tokens)."""

UNIT = "ms"
SPAN = "engine.decode.issue"


def read(run):
    tr = run.trace
    walls = [e - s for n, s, e in tr.host if n == SPAN] if tr is not None else []
    return sum(walls) / len(walls) / 1e6 if walls else None
