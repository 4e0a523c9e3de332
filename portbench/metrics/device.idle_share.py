"""Device layer (the H100): the share of the profiled stretch in which no
device activity ran on any stream (the union of their spans)."""

UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
