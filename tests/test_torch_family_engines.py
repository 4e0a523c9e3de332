"""The port's serving engine on every model family against the JAX
package's engine, on the CPU at reduced sizes.

With the same weights (``_torch_family.family``) and the same prompts,
the port's monolithic engine gives the JAX monolithic engine's greedy
tokens on each family, with slots recycled (more requests than rows),
so ``reset_row`` runs between requests.  The stub frames and patch
embeddings cannot be drawn alike in the two packages (JAX's PRNG), so
the port's engine and prefill worker are handed the JAX engine's stub
arrays: ``extra_inputs`` is replaced where they import it.  Both
packages refuse ping-pong and the paged layout on the recurrent,
state-space and cross kinds.  This file holds the recurrent,
state-space and softcapped families; the cross-attention and MoE
families are in ``test_torch_family_engines_cross.py``, the ping-pong
runtime on the three families it serves in
``test_torch_family_pingpong.py``, whisper's prefill worker and
``reset_row`` in ``test_torch_family_worker.py``.
"""
import pytest
import torch

import _torch_family as tf_
from _torch_family import WORKLOAD, jax_engine, patch_stubs, port_engine, prompts, serve
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine, Request

torch.set_num_threads(1)

MONO_IDS = ["gemma2-27b", "recurrentgemma-2b", "recurrentgemma-2b+remainder",
            "mamba2-1.3b"]


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


REFUSED = ["recurrentgemma-2b", "mamba2-1.3b", "whisper-large-v3",
           "llama-3.2-vision-90b"]


@pytest.mark.parametrize("fid", REFUSED)
def test_pingpong_refuses_the_new_kinds_in_both(fid):
    """The disaggregated runtime serves attn / local layers only, in the
    JAX package and in the port."""
    from repro.core.disagg import DisaggregatedInstance as JInst
    from repro_torch.core.disagg import DisaggregatedInstance
    fam = tf_.family(fid)
    with pytest.raises(NotImplementedError, match="layer kind"):
        JInst(fam.jcfg, fam.params_j)
    with pytest.raises(NotImplementedError, match="layer kind"):
        DisaggregatedInstance(fam.tcfg, fam.params_t)


@pytest.mark.parametrize("fid", REFUSED)
def test_paged_layout_refuses_the_new_kinds_in_both(fid):
    """Pages hold k / v / pos only: recurrent states and cross K/V refuse
    the paged layout in both packages' engines."""
    from repro.serving.config import ServingConfig as JConfig
    from repro.serving.engine import Engine as JEngine
    from repro.serving.pages import PageError as JPageError
    from repro_torch.serving.pages import PageError
    fam = tf_.family(fid)
    kw = dict(max_batch=2, max_seq=32, kv_layout="paged", page_size=8,
              verbose=False)
    with pytest.raises(JPageError, match="layer kind"):
        JEngine(fam.jcfg, fam.params_j, config=JConfig(**kw))
    with pytest.raises(PageError, match="layer kind"):
        Engine(fam.tcfg, fam.params_t, config=ServingConfig(device="cpu", **kw))
