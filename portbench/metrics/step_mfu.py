"""Whole step: the model FLOPs the window's tokens need
(``work/model_step.py``: decode tokens over their real context, prompts
admitted in the window, routed top-k experts and the dense residual)
over the window's seconds at the bf16 peak."""

from harness import peaks
from harness.spec import work_module

UNIT = "%"


def read(run):
    if not run.steps:
        return None
    flops = work_module("model_step").step_flops(run.config, run.steps)
    return 100.0 * flops / (run.window_s * peaks.FLOPS[run.config["torch_dtype"]])
