"""Whisper large-v3 — encoder-decoder audio model [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings (1500 frames).
32 encoder layers + 32 decoder layers (self + cross + FFN).
decode_32k exceeds the real model's 448-token decoder context — exercised
mechanically as a synthetic shape (documented in DESIGN.md).
"""
from repro_torch.config import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3", arch_type="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866,
    block_pattern=("selfcross",), act="gelu",
    encoder=EncoderConfig(n_layers=32, source_len=1500),
    long_context_note="decoder max ctx 448; long_500k architecturally meaningless",
    source="arXiv:2212.04356",
))
