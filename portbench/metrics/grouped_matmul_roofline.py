"""Kernels layer (``kernels/grouped_matmul.py``, ``csrc/grouped_matmul.cu``):
the least time of the routed work its launches needed
(``work/grouped_matmul.py``) over their device time, in the profiled
stretch."""

UNIT = "%"
KERNEL = "grouped_matmul"


def read(run):
    return run.roofline(KERNEL)
