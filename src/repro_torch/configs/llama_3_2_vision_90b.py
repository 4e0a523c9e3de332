"""Llama-3.2-Vision 90B backbone — 100 layers, gated cross-attention to
image patch embeddings every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision].

The ViT/SigLIP vision encoder + projector is a STUB per the assignment:
input_specs() provides precomputed patch embeddings (6404 = 4 tiles x 1601).
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b", arch_type="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256,
    block_pattern=("cross", "attn", "attn", "attn", "attn"),
    rope_theta=500000.0, cross_source_len=6404,
    long_context_note="pure full attention; long_500k skipped",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
