"""Runtime layer (``core/disagg.py``): expert-stage device time per
decode iteration, from ``DisaggregatedInstance.stage_report()`` (CUDA
events on the expert stream) after ``reset_stage_times()`` at the
window's start."""

UNIT = "ms"


def read(run):
    st = run.stages
    if not st or not st.get("expert_n"):
        return None
    return 1e3 * st["expert_s"] / run.decode_iters
