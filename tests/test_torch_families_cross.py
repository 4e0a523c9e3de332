"""The cross-attention families (whisper-large-v3 with its encoder,
llama-3.2-vision-90b's gated cross layers) and the MoE families
(qwen2-moe-a2.7b's shared experts, arctic-480b's dense residual) of the
port against the JAX package, on the CPU at reduced sizes: the checks
and tolerances of ``test_torch_families.py``.  The stub frames and patch
embeddings are the JAX package's, handed to both."""
import pytest

from _torch_family import check_family

IDS = ["whisper-large-v3", "llama-3.2-vision-90b", "qwen2-moe-a2.7b",
       "arctic-480b"]


@pytest.mark.parametrize("fid", IDS)
def test_family_prefill_and_decode_match_jax(fid):
    check_family(fid)
