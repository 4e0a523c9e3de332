"""Whisper-large-v3's prefill-worker path and ``reset_row`` on the
recurrent, state-space and cross caches, against the JAX package on the
CPU.  The worker (``prefill_devices=1``) prefills one request per batch
(the stubs are drawn per batch) and moves its KV at admission; the JAX
engine with its worker gives the same greedy tokens.  ``reset_row``
leaves the cache the JAX one leaves, exactly."""
import numpy as np
import pytest
import torch

import _torch_family as tf_
from _torch_family import WORKLOAD, jax_engine, patch_stubs, port_engine, prompts, serve
from repro_torch.serving.engine import Request

torch.set_num_threads(1)


def test_whisper_worker_path_matches_jax(monkeypatch):
    """Prefill on the prefill worker (``prefill_devices=1``): one request
    per batch (the stubs are per batch), KV moved at admission; the
    JAX engine with its worker gives the same tokens."""
    from repro.serving.engine import Request as JRequest
    fam = tf_.family("whisper-large-v3")
    patch_stubs(monkeypatch, fam)
    ps = prompts(fam.tcfg.vocab, seed=1)
    want = serve(jax_engine(fam, worker=True), ps, JRequest)
    eng = port_engine(fam, worker=True)
    got = serve(eng, ps, Request)
    assert got == want
    st = eng.stats()
    assert st["disagg_prefill"]
    assert st["phases"]["prefill_batches"] == WORKLOAD["n_requests"]
    assert st["transport"]["kv"]["hops"] == WORKLOAD["n_requests"]


@pytest.mark.parametrize("fid", ["recurrentgemma-2b+remainder", "mamba2-1.3b",
                                 "whisper-large-v3"])
def test_reset_row_matches_jax(fid):
    """After a prefill into every row, resetting row 1 leaves the cache
    the JAX ``reset_row`` leaves: positions -1 and recurrent states 0 on
    that row, the conv caches and cross K/V as they were."""
    from repro.serving.kvcache import reset_row as jreset
    from repro_torch.bridge import cache_from_jax
    from repro_torch.serving.kvcache import reset_row
    fam = tf_.family(fid)
    jx = fam.jx
    toks = np.random.RandomState(3).randint(2, fam.tcfg.vocab, (3, 5)).astype(np.int32)
    _, cj = jx.tf.prefill(fam.params_j, fam.jcfg, jx.jnp.asarray(toks), max_seq=16,
                          **tf_.jax_extras(fam, 3))
    ct = cache_from_jax(jx.jax.tree.map(np.asarray, cj), fam.tcfg, device="cpu")
    before = [{k: v.clone() for k, v in e.items()} for e in ct]
    reset_row(ct, 1)
    want = cache_from_jax(jx.jax.tree.map(np.asarray, jreset(cj, fam.jcfg, 1, 16)),
                          fam.tcfg, device="cpu")
    changed = set()
    for a, b, c in zip(ct, want, before):
        for k in a:
            assert torch.equal(a[k], b[k]), k
            if not torch.equal(a[k], c[k]):
                changed.add(k)
    assert changed == {k for e in ct for k in e if k in ("pos", "h", "ssm")}
