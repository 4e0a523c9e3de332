"""Runtime layer (``core/disagg.py``): attention plus combine stage device
time per decode iteration, from ``DisaggregatedInstance.stage_report()``
(CUDA events on the attention stream) after ``reset_stage_times()`` at
the window's start."""

UNIT = "ms"


def read(run):
    st = run.stages
    if not st or not st.get("attn_n"):
        return None
    return 1e3 * (st["attn_s"] + st["combine_s"]) / run.decode_iters
