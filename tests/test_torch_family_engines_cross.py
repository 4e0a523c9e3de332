"""The port's monolithic engine on the cross-attention families
(whisper-large-v3, llama-3.2-vision-90b) and the MoE families
(qwen2-moe-a2.7b, arctic-480b) against the JAX engine on the CPU, as in
``test_torch_family_engines.py``.  Greedy tokens identical; the stubs
are the JAX engine's."""
import pytest
import torch

import _torch_family as tf_
from _torch_family import WORKLOAD, jax_engine, patch_stubs, port_engine, prompts, serve
from repro_torch.serving.engine import Request

torch.set_num_threads(1)

MONO_IDS = ["whisper-large-v3", "llama-3.2-vision-90b", "qwen2-moe-a2.7b",
            "arctic-480b"]


@pytest.mark.parametrize("fid", MONO_IDS)
def test_monolithic_engine_matches_jax(monkeypatch, fid):
    from repro.serving.engine import Request as JRequest
    fam = tf_.family(fid)
    patch_stubs(monkeypatch, fam)
    ps = prompts(fam.tcfg.vocab)
    want = serve(jax_engine(fam), ps, JRequest)
    eng = port_engine(fam)
    got = serve(eng, ps, Request)
    assert len(got) == WORKLOAD["n_requests"]
    assert got == want
    assert eng.stats()["prefills"] == WORKLOAD["n_requests"]
