"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default.  Asking for the card on
a machine without one is an error, never a quiet move to the CPU: the
CPU runs only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def kernel_route(t: torch.Tensor) -> str:
    """Which version of a kernel a tensor takes: ``"cuda"`` for a CUDA
    tensor (the hand-written kernel), ``"plain"`` for a CPU tensor (the
    plain PyTorch version) and for a ``meta`` tensor (shapes only: the
    dry run counts the plain version's ops).  Any other device raises."""
    if t.is_cuda:
        return "cuda"
    if t.device.type in ("cpu", "meta"):
        return "plain"
    raise ValueError(f"no kernel for tensors on {t.device}")
