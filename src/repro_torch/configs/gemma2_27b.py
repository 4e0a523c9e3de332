"""Gemma-2 27B — alternating local(4096-window)/global attention, logit
softcapping, pre+post norms, GeGLU, tied embeddings [arXiv:2408.00118].

long_500k note: the 500k-decode variant runs ALL layers with the
sliding-window kernel (global layers would need a 524k-token KV cache);
this is a documented deviation recorded in DESIGN.md.
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b", arch_type="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    block_pattern=("local", "attn"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0, use_post_norm=True,
    act="gelu", tie_embeddings=True,
    supports_long_context=True,
    long_context_note="500k decode runs all layers sliding-window (deviation)",
    source="arXiv:2408.00118",
))
