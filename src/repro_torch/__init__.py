"""PyTorch/CUDA port of the MegaScale-Infer reproduction.

Mirrors ``src/repro``'s layout (config, configs, models, kernels, core,
serving, launch) and imports nothing of it: the JAX package is the
reference the port is tested against, and only the tests import both.

Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``.  Each hand-written CUDA kernel is called
through a wrapper that launches it for a CUDA tensor and takes the
kernel's plain PyTorch version for a CPU tensor.
"""
from repro_torch.device import resolve_device  # noqa: F401
