"""Importing this package registers every architecture config, the JAX
package's registry (``repro/configs/``) copied field for field."""
from repro_torch.configs import (arctic_480b, gemma2_27b,  # noqa: F401
                                 granite_3_8b, llama_3_2_vision_90b,
                                 mamba2_13b, minitron_4b, minitron_8b,
                                 paper_models, qwen2_moe_a27b,
                                 recurrentgemma_2b, whisper_large_v3)

ASSIGNED = [
    "minitron-4b", "llama-3.2-vision-90b", "gemma2-27b", "recurrentgemma-2b",
    "qwen2-moe-a2.7b", "granite-3-8b", "mamba2-1.3b", "whisper-large-v3",
    "minitron-8b", "arctic-480b",
]
PAPER = ["mixtral-8x22b", "dbrx", "scaled-moe"]
