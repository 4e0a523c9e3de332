"""Model layer (``models/transformer.py``): mean host wall time of the
``model.prefill`` spans in the profiled stretch, one an inline prefill:
the host's issue of the prefill, which returns before the device ends
it."""

UNIT = "ms"
SPAN = "model.prefill"


def read(run):
    tr = run.trace
    walls = [e - s for n, s, e in tr.host if n == SPAN] if tr is not None else []
    return sum(walls) / len(walls) / 1e6 if walls else None
