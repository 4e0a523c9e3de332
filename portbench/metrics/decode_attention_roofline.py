"""Kernels layer (``kernels/decode_attention.py``,
``csrc/decode_attention.cu``): the least time of the valid KV positions'
work its launches needed (``work/decode_attention.py``) over their device
time, split and merge kernels both, in the profiled stretch."""

UNIT = "%"
KERNEL = "decode_attention"


def read(run):
    return run.roofline(KERNEL)
