"""Minitron-8B — width-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=256000,
    block_pattern=("attn",),
    long_context_note="pure full attention; long_500k skipped",
    source="arXiv:2407.14679",
))
