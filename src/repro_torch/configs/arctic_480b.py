"""Snowflake Arctic 480B — 128 experts top-2 MoE + parallel dense-FFN
residual [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.config import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b", arch_type="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=32000,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  d_ff_dense_residual=4864),
    long_context_note="pure full attention; long_500k skipped",
    source="hf:Snowflake/snowflake-arctic-base",
))
