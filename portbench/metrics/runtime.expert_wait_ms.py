"""Runtime layer (``core/disagg.py``): how long the expert stream stalled
per decode iteration waiting for micro-batches at the M2N hops
(``stage_report()["m2n_wait_s"]``, CUDA events around each stream wait)
over the window, after ``reset_stage_times()`` at its start."""

UNIT = "ms"


def read(run):
    st = run.stages
    if not st or "m2n_wait_s" not in st or not run.decode_iters:
        return None
    return 1e3 * st["m2n_wait_s"] / run.decode_iters
