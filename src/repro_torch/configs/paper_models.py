"""The paper's own evaluation models (MegaScale-Infer Table 4)."""
from repro_torch.config import ModelConfig, MoEConfig, register

MIXTRAL_8X22B = register(ModelConfig(
    name="mixtral-8x22b", arch_type="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=32000,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    long_context_note="paper model; long_500k not assigned",
    source="MegaScale-Infer Table 4 / mistral.ai",
))

DBRX = register(ModelConfig(
    name="dbrx", arch_type="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=100352,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    long_context_note="paper model",
    source="MegaScale-Infer Table 4 / databricks",
))

SCALED_MOE = register(ModelConfig(
    name="scaled-moe", arch_type="moe",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=100352,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=32, top_k=4, d_ff_expert=8192),
    long_context_note="paper model",
    source="MegaScale-Infer Table 4",
))
