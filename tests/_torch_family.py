"""Helpers shared by the model-family parity tests of the port
(``tests/test_torch_families*.py``, ``tests/test_torch_family_*.py``).

``family(name)`` builds one reduced config in both packages with the
same weights: JAX ``init_params`` from ``PRNGKey(0)``, carried to the
port through ``repro_torch.bridge``.  The llama-3.2-vision ``cross``
layers start with their tanh gates at 0, which makes every cross layer
the identity; the gates are opened to 0.5 (in the numpy tree both
packages read) so the parity tests see the cross path.  Stub inputs are
the JAX package's (``repro.models.stubs.extra_inputs``), handed to the
port as tensors, since torch cannot draw JAX's random numbers.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.models import transformer as ttf
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine

# logits and cache values: the JAX package's runtime-parity tolerance
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)

# reduced configs of the families, by test id: (registry name, remainder
# put back or None).  ``reduced`` drops the remainder pattern, so
# recurrentgemma-2b's ("rglru", "rglru") tail is held on its own variant
FAMILIES = {
    "gemma2-27b": ("gemma2-27b", None),
    "recurrentgemma-2b": ("recurrentgemma-2b", None),
    "recurrentgemma-2b+remainder": ("recurrentgemma-2b", ("rglru", "rglru")),
    "mamba2-1.3b": ("mamba2-1.3b", None),
    "whisper-large-v3": ("whisper-large-v3", None),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", None),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", None),
    "arctic-480b": ("arctic-480b", None),
}


def jax_modules():
    import jax
    import jax.numpy as jnp

    from repro import config as jconfig
    from repro.models import stubs as jstubs
    from repro.models import transformer as jtf
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig,
                                 stubs=jstubs, tf=jtf)


def _configs(jx, name, remainder):
    jcfg = jx.config.reduced(jx.config.get_config(name))
    tcfg = tconfig.reduced(tconfig.get_config(name))
    if remainder is not None:
        n = len(jcfg.block_pattern) * jcfg.n_blocks + len(remainder)
        jcfg = dataclasses.replace(jcfg, remainder_pattern=remainder, n_layers=n)
        tcfg = dataclasses.replace(tcfg, remainder_pattern=remainder, n_layers=n)
    return jcfg, tcfg


def open_gates(tree: dict) -> dict:
    """Set every cross layer's tanh gates to 0.5 in a numpy param tree."""
    for entry in tuple(tree["blocks"]) + tuple(tree["remainder"]):
        for g in ("gate_attn", "gate_ffn"):
            if g in entry:
                entry[g] = np.full_like(entry[g], 0.5)
    return tree


def family(fid: str):
    pytest.importorskip("jax")
    jx = jax_modules()
    name, remainder = FAMILIES[fid]
    jcfg, tcfg = _configs(jx, name, remainder)
    np_params = open_gates(jx.jax.tree.map(
        np.asarray, jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))))
    params_j = jx.jax.tree.map(jx.jnp.asarray, np_params)
    params_t = params_from_jax(np_params, tcfg, device="cpu")
    return types.SimpleNamespace(jx=jx, jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                                 params_j=params_j, params_t=params_t)


def jax_extras(fam, batch: int) -> dict:
    """The JAX package's stub inputs for ``batch`` rows, as numpy."""
    ex = fam.jx.stubs.extra_inputs(fam.jcfg, batch)
    return {k: np.asarray(v) for k, v in ex.items()}


def torch_extras(np_extras: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in np_extras.items()}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want):
    np.testing.assert_allclose(_np(got).astype(np.float32),
                               np.asarray(want, np.float32), **LOGIT_TOL)


def _same_cache(ct, cj_tree, tcfg):
    ct_j = cache_from_jax(cj_tree, tcfg, device="cpu")
    assert len(ct) == len(ct_j) == tcfg.n_layers
    for kind, a, b in zip(tcfg.layer_kinds, ct, ct_j):
        assert a.keys() == b.keys(), kind
        for key in a:
            assert a[key].dtype == b[key].dtype, (kind, key)
            if key == "pos":
                np.testing.assert_array_equal(_np(a[key]), _np(b[key]))
            else:
                _close(a[key], _np(b[key]))


def check_family(fid: str):
    """Bridge, prefill and three decode steps of one family against JAX."""
    fam = family(fid)
    jx, jcfg, tcfg = fam.jx, fam.jcfg, fam.tcfg
    assert tcfg.layer_kinds == (jcfg.block_pattern * jcfg.n_blocks
                                + jcfg.remainder_pattern)
    # the bridge: one dict per layer in execution order, leaves as they were
    assert len(fam.params_t["layers"]) == tcfg.n_layers
    for l, lp in enumerate(fam.params_t["layers"]):
        i, pat = divmod(l, len(jcfg.block_pattern))
        src = (fam.np_params["blocks"][pat] if i < jcfg.n_blocks
               else fam.np_params["remainder"][l - jcfg.n_blocks
                                               * len(jcfg.block_pattern)])
        for k, v in lp.items():
            want = src[k][i] if i < jcfg.n_blocks else src[k]
            np.testing.assert_array_equal(_np(v), want)
    rng = np.random.RandomState(4)
    B, T, max_seq = 2, 6, 16
    toks = rng.randint(0, tcfg.vocab, size=(B, T)).astype(np.int32)
    ex = jax_extras(fam, B)
    lj, cj = jx.tf.prefill(fam.params_j, jcfg, jx.jnp.asarray(toks),
                           max_seq=max_seq, **ex)
    lt, ct = ttf.prefill(fam.params_t, tcfg, torch.from_numpy(toks),
                         max_seq=max_seq, **torch_extras(ex))
    _close(lt, lj)
    _same_cache(ct, jx.jax.tree.map(np.asarray, cj), tcfg)
    nj = np.asarray(jx.jnp.argmax(lj, -1)).astype(np.int32)
    nt = torch.argmax(lt, -1)
    np.testing.assert_array_equal(_np(nt), nj)
    pos = np.full((B,), T, np.int32)
    for _ in range(3):
        lj, cj = jx.tf.decode_step(fam.params_j, jcfg, jx.jnp.asarray(nj), cj,
                                   jx.jnp.asarray(pos))
        lt, ct = ttf.decode_step(fam.params_t, tcfg, nt, ct, torch.from_numpy(pos))
        _close(lt, lj)
        nj = np.asarray(jx.jnp.argmax(lj, -1)).astype(np.int32)
        nt = torch.argmax(lt, -1)
        np.testing.assert_array_equal(_np(nt), nj)
        pos = pos + 1
    _same_cache(ct, jx.jax.tree.map(np.asarray, cj), tcfg)


# ---------------------------------------------------------------- engines
WORKLOAD = dict(n_requests=5, max_new=4, max_batch=2, max_seq=32, prompt_len=6)

def prompts(vocab, seed=0, n=WORKLOAD["n_requests"]):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=WORKLOAD["prompt_len"]).tolist()
            for _ in range(n)]


def serve(engine, prompt_list, request_cls):
    for i, p in enumerate(prompt_list):
        engine.submit(request_cls(rid=i, prompt=list(p),
                                  max_new_tokens=WORKLOAD["max_new"]))
    engine.run_until_done()
    return {r.rid: list(r.generated) for r in engine.finished}


def patch_stubs(monkeypatch, fam):
    """The port's engine and worker draw the JAX engine's stubs."""
    def stubs(cfg, batch, *a, **kw):
        return torch_extras(jax_extras(fam, batch))
    monkeypatch.setattr("repro_torch.serving.engine.extra_inputs", stubs)
    monkeypatch.setattr("repro_torch.serving.prefill.extra_inputs", stubs)


def jax_engine(fam, runtime="monolithic", worker=False, m=2):
    from repro.core.disagg import DisaggPlan, DisaggregatedInstance
    from repro.serving.config import ServingConfig as JConfig
    from repro.serving.engine import Engine as JEngine
    from repro.serving.prefill import PrefillWorker as JWorker
    inst = (DisaggregatedInstance(fam.jcfg, fam.params_j,
                                  plan=DisaggPlan(n_microbatches=m))
            if runtime == "pingpong" else None)
    w = (JWorker(fam.jcfg, fam.params_j, max_seq=WORKLOAD["max_seq"])
         if worker else None)
    return JEngine(fam.jcfg, fam.params_j, runtime=inst, prefill_worker=w,
                   config=JConfig(max_batch=WORKLOAD["max_batch"],
                                  max_seq=WORKLOAD["max_seq"], runtime=runtime,
                                  microbatches=m, verbose=False))


def port_engine(fam, runtime="monolithic", worker=False, m=2):
    from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
    from repro_torch.serving.prefill import PrefillWorker
    inst = (DisaggregatedInstance(fam.tcfg, fam.params_t, DisaggPlan(m))
            if runtime == "pingpong" else None)
    w = (PrefillWorker(fam.tcfg, fam.params_t, max_seq=WORKLOAD["max_seq"])
         if worker else None)
    return Engine(fam.tcfg, fam.params_t, runtime=inst, prefill_worker=w,
                  config=ServingConfig(max_batch=WORKLOAD["max_batch"],
                                       max_seq=WORKLOAD["max_seq"],
                                       runtime=runtime, microbatches=m,
                                       device="cpu", verbose=False))
