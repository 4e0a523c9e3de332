"""Hand-written CUDA kernels of the port (``repro_torch/csrc``), each with
its plain PyTorch version beside it; ``ops`` is the public entry."""
