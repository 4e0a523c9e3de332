"""Runtime layer (``core/disagg.py``): how long the attention stream
stalled per decode iteration waiting for the expert stream's returns at
the N2M hops (``stage_report()["n2m_wait_s"]``, CUDA events around each
stream wait) over the window, after ``reset_stage_times()`` at its
start."""

UNIT = "ms"


def read(run):
    st = run.stages
    if not st or "n2m_wait_s" not in st or not run.decode_iters:
        return None
    return 1e3 * st["n2m_wait_s"] / run.decode_iters
