"""Qwen1.5/2-MoE A2.7B — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.config import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b", arch_type="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab=151936,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4, d_ff_shared=5632),
    long_context_note="pure full attention; long_500k skipped",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
