"""Granite-3 8B — GQA dense [hf:ibm-granite/granite-3.0-2b-base family]."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-8b", arch_type="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab=49155,
    block_pattern=("attn",),
    long_context_note="pure full attention; long_500k skipped",
    source="hf:ibm-granite/granite-3.0-2b-base",
))
