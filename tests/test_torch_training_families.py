"""The port's training loss and every parameter gradient against
``jax.value_and_grad`` of the JAX package's ``lm_loss``, one reduced
config per family, for each ``remat`` mode, on the CPU in f32.

Per family: the JAX params (``PRNGKey(0)``; llama-3.2-vision's cross
gates opened to 0.5, as ``_torch_family`` does) carried across by
``bridge.params_from_jax``, one batch of tokens drawn with numpy, the
JAX package's stub frames / patches.  The MoE families' routing (top-k
experts of every MoE layer) is compared first and must be identical:
at a near-tie one flipped expert changes every gradient downstream.
Then:
  * loss, aux and total: rtol 1e-5 (f32, the same math summed in
    another order);
  * every gradient leaf: |port - JAX| <= 1e-4 * max |JAX| over the leaf.
``remat`` changes what backward keeps, never a value: each mode is held
against JAX's own run of that mode.
"""
import numpy as np
import pytest
import torch

from _torch_family import _configs, jax_modules, open_gates
from repro_torch.bridge import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.training import loop as tloop
from repro_torch.training.optimizer import leaves, named_leaves

torch.set_num_threads(1)

FAMILIES = ["minitron-4b", "mixtral-8x22b", "qwen2-moe-a2.7b",
            "recurrentgemma-2b", "mamba2-1.3b", "whisper-large-v3",
            "llama-3.2-vision-90b"]
B, T = 2, 17          # 16 next-token targets per row
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _jax_routing(jx, jcfg, params_j, toks, extras):
    """Top-k experts of every MoE layer of the JAX forward, in layer
    order (recorded from inside the scan with ``jax.debug.callback``)."""
    from repro.models import moe as jmoe
    seen = []
    orig = jmoe.route

    def recording(x, w, k, bias=None):
        r = orig(x, w, k, bias)
        jx.jax.debug.callback(lambda e: seen.append(np.asarray(e)), r.experts,
                              ordered=True)
        return r

    jmoe.route = recording
    try:
        h, _ = jx.tf.forward_hidden(params_j, jcfg, jx.jnp.asarray(toks[:, :-1]),
                                    remat="none", **extras)
        h.block_until_ready()
        jx.jax.effects_barrier()
    finally:
        jmoe.route = orig
    return seen


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    pytest.importorskip("jax")
    jx = jax_modules()
    from repro.models import stubs as jstubs
    jcfg, tcfg = _configs(jx, request.param, None)
    np_params = open_gates(jx.jax.tree.map(
        np.asarray, jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))))
    params_j = jx.jax.tree.map(jx.jnp.asarray, np_params)
    toks = np.random.RandomState(11).randint(
        0, tcfg.vocab, size=(B, T)).astype(np.int32)
    ex = {k: np.asarray(v) for k, v in jstubs.extra_inputs(jcfg, B).items()}
    ex_j = {k: jx.jnp.asarray(v) for k, v in ex.items()}
    routing = (_jax_routing(jx, jcfg, params_j, toks, ex_j)
               if tcfg.moe is not None else None)
    return dict(jx=jx, jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                params_j=params_j, toks=toks, ex=ex, ex_j=ex_j, routing=routing)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_every_gradient_match_jax(fam, remat, monkeypatch):
    jx, jcfg, tcfg = fam["jx"], fam["jcfg"], fam["tcfg"]
    from repro.training import loop as jloop

    vg = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, t, e: jloop.lm_loss(p, jcfg, t, e, remat), has_aux=True))
    (tot_j, (loss_j, aux_j)), grads_j = vg(fam["params_j"],
                                           jx.jnp.asarray(fam["toks"]), fam["ex_j"])

    params = params_from_jax(fam["np_params"], tcfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    seen = []
    orig = tmoe.route

    def recording(*a, **kw):
        r = orig(*a, **kw)
        seen.append(r.experts.numpy().copy())
        return r

    monkeypatch.setattr(tmoe, "route", recording)
    extras = {k: torch.from_numpy(np.array(v)) for k, v in fam["ex"].items()}
    tot, (loss, aux) = tloop.lm_loss(params, tcfg, torch.from_numpy(fam["toks"]),
                                     extras, remat)
    if fam["routing"] is not None:      # routing first, from the forward
        assert len(seen) == len(fam["routing"]) == tcfg.n_layers
        for layer, (got, want) in enumerate(zip(seen, fam["routing"])):
            np.testing.assert_array_equal(got, want, err_msg=f"layer {layer}")
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=LOSS_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(tot.item(), float(tot_j), rtol=LOSS_RTOL)
    if tcfg.moe is not None:
        assert aux.item() > 0
    tot.backward()

    want = dict(named_leaves(params_from_jax(
        jx.jax.tree.map(np.asarray, grads_j), tcfg, device="cpu")))
    got = dict(named_leaves(params))
    assert got.keys() == want.keys()
    for path, p in got.items():
        w = want[path].numpy()
        assert p.grad is not None, path
        g = p.grad.numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, f"{path}: JAX gradient is all zero"
        err = float(np.abs(g - w).max())
        assert err <= GRAD_RTOL * scale, f"{path}: {err:.3e} > 1e-4 x {scale:.3e}"
