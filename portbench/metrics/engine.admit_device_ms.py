"""Engine layer (``serving/engine.py``): device time per admitted
request, from the port's own spans in the profiled stretch: the union of
device activity inside the ``engine.admit`` spans that admitted anyone
(each ends in the host's read of the first tokens, so its device work
lies inside it), over the ``engine.admit.insert`` spans in them, one a
request.  Beside ``engine.admit_ms`` (wall) it tells the admission's
device time from its host time."""

UNIT = "ms"
SPAN, PER = "engine.admit", "engine.admit.insert"


def busy_within(busy, s, e):
    """Nanoseconds of the disjoint ``busy`` spans inside [s, e]."""
    return sum(max(0, min(e, b1) - max(s, b0)) for b0, b1 in busy
               if b1 > s and b0 < e)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    inserts = [s for name, s, _ in tr.host if name == PER]
    admits = [(s, e, sum(1 for i in inserts if s <= i <= e))
              for name, s, e in tr.host if name == SPAN]
    admits = [a for a in admits if a[2]]
    if not admits:
        return None
    busy = sum(busy_within(tr.busy, s, e) for s, e, _ in admits)
    return busy / 1e6 / sum(n for *_, n in admits)
