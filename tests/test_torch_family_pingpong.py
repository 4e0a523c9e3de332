"""The port's ping-pong runtime on the new attention families against
the JAX package's, on the CPU at reduced sizes: qwen2-moe-a2.7b (60
experts top-4 and 4 shared experts in the full config), arctic-480b (128
experts top-2 and a dense residual) and gemma2-27b (local / global
attention with softcaps, post-norms and a dense FFN).

The same requests through the JAX ping-pong engine (m = 2) and the
port's: greedy tokens identical, and on the MoE families identical
``expert_loads`` (routed-token counts per expert, integers) in the
engines' ``stats()``.  The port's monolithic engine gives the same
tokens too.
"""
import pytest
import torch

import _torch_family as tf_
from _torch_family import WORKLOAD, jax_engine, port_engine, prompts, serve
from repro_torch.serving.engine import Request

torch.set_num_threads(1)


@pytest.mark.parametrize("fid", ["qwen2-moe-a2.7b", "arctic-480b", "gemma2-27b"])
def test_pingpong_engine_matches_jax(fid):
    from repro.serving.engine import Request as JRequest
    fam = tf_.family(fid)
    ps = prompts(fam.tcfg.vocab, seed=2)
    jeng = jax_engine(fam, runtime="pingpong")
    want = serve(jeng, ps, JRequest)
    eng = port_engine(fam, runtime="pingpong")
    got = serve(eng, ps, Request)
    assert len(got) == WORKLOAD["n_requests"]
    assert got == want
    assert serve(port_engine(fam), ps, Request) == want
    st, jst = eng.stats(), jeng.stats()
    assert st["n_microbatches"] == jst["n_microbatches"] == 2
    if fam.tcfg.moe is not None:
        assert st["expert_loads"] == jst["expert_loads"]
        assert sum(st["expert_loads"]) == (fam.tcfg.moe.top_k * fam.tcfg.n_layers
                                           * (st["tokens"] - st["prefills"]))
    else:
        assert "expert_loads" not in st and "expert_loads" not in jst
