"""Mamba-2 1.3B — attention-free SSD (state-space duality)
[arXiv:2405.21060].  d_inner=4096, 64 heads of dim 64, state 128."""
from repro_torch.config import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b", arch_type="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280,
    block_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    supports_long_context=True,
    long_context_note="constant-size SSM state: O(1) decode",
    source="arXiv:2405.21060",
))
