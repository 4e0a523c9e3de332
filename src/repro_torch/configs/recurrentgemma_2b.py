"""RecurrentGemma-2B — Griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427].  26 layers = 8 x (rglru, rglru, local) + 2 rglru."""
from repro_torch.config import ModelConfig, RGLRUConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000,
    block_pattern=("rglru", "rglru", "local"),
    remainder_pattern=("rglru", "rglru"),
    window=2048, act="gelu", tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560),
    supports_long_context=True,
    long_context_note="RG-LRU state + 2048-window local attn: O(1) decode state",
    source="arXiv:2402.19427",
))
