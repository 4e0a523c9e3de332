"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-4b", arch_type="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000,
    block_pattern=("attn",),
    long_context_note="pure full attention; long_500k skipped",
    source="arXiv:2407.14679",
))
