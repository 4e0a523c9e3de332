"""The port's trainer (``repro_torch.training``, ``launch.train``) against
the JAX package's, on the CPU at reduced sizes, f32.

Inputs are drawn with numpy from a seed and handed to both packages;
JAX params and optimizer states reach the port through
``repro_torch.bridge``.  Tolerances:
  * the load-balance loss and the MoE aux: rtol 1e-6 (the same f32
    arithmetic); the MoE output 1e-5 (``test_torch_layers.py``);
  * ``forward_hidden`` / ``forward_train``: 5e-4, the runtime-parity
    tolerance of the JAX package (``tests/test_disagg_kernels.py``);
  * ``cosine_lr`` and one ``adamw_update``: rtol 1e-6;
  * three ``train`` steps: losses rtol 1e-4, final params within 1e-4
    of each leaf's max |p|;
  * data batches and checkpoint round trips: exact.
The loss and gradients of every family are in
``test_torch_training_families.py``.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_family import FAMILIES, _configs
from repro_torch import config as tconfig
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.kernels import cuda_build
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import loop as tloop
from repro_torch.training import optimizer as topt
from repro_torch.training.data import DataConfig, SyntheticLM

torch.set_num_threads(1)

AUX_TOL = dict(rtol=1e-6, atol=1e-7)
OPT_TOL = dict(rtol=1e-6, atol=1e-9)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp

    from repro import config as jconfig
    from repro.models import moe as jmoe
    from repro.models import transformer as jtf
    from repro.training import checkpoint as jckpt
    from repro.training import data as jdata
    from repro.training import loop as jloop
    from repro.training import optimizer as jopt
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig, moe=jmoe,
                                 tf=jtf, ckpt=jckpt, data=jdata, loop=jloop,
                                 opt=jopt)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _model(jx, name, seed=0):
    """(jax cfg, port cfg, jax params, numpy params) of a reduced config."""
    jcfg = jx.config.reduced(jx.config.get_config(name))
    tcfg = tconfig.reduced(tconfig.get_config(name))
    pj = jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(seed))
    return jcfg, tcfg, pj, jx.jax.tree.map(np.asarray, pj)


# ------------------------------------------------------------------ MoE aux
def test_load_balance_loss_matches_jax(jx):
    rng = np.random.RandomState(0)
    T, d, E = 24, 16, 6
    x, w = rng.randn(T, d).astype(np.float32), rng.randn(d, E).astype(np.float32)
    for k in (1, 2, 3):
        rj = jx.moe.route(jx.jnp.asarray(x), jx.jnp.asarray(w), k)
        rt = tmoe.route(_t(x), _t(w), k)
        np.testing.assert_array_equal(rt.experts.numpy(), np.asarray(rj.experts))
        np.testing.assert_allclose(float(tmoe.load_balance_loss(rt, E)),
                                   float(jx.moe.load_balance_loss(rj, E)), **AUX_TOL)


@pytest.mark.parametrize("cap_mode,extras", [("train", False), ("full", True)])
def test_moe_ffn_aux_matches_jax(jx, cap_mode, extras):
    """``moe_ffn(with_aux=True)`` gives JAX's (y, aux); without it, the
    same y and aux None."""
    rng = np.random.RandomState(3)
    T, d, E, f = 16, 32, 4, 48
    cfg = tconfig.MoEConfig(n_experts=E, top_k=2, d_ff_expert=f)
    r = lambda *s: rng.randn(*s).astype(np.float32) * 0.2
    p = {"router": r(d, E) * 5, "we1": r(E, d, f), "we3": r(E, d, f),
         "we2": r(E, f, d)}
    if extras:
        p.update(ws1=r(d, f), ws3=r(d, f), ws2=r(f, d), shared_gate=r(d))
    x = rng.randn(T, d).astype(np.float32)
    pt = {k: _t(v) for k, v in p.items()}
    y, aux = tmoe.moe_ffn(pt, _t(x), cfg, "silu", cap_mode, with_aux=True)
    yj, auxj = jx.moe.moe_ffn({k: jx.jnp.asarray(v) for k, v in p.items()},
                              jx.jnp.asarray(x), cfg, "silu", cap_mode)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(auxj), **AUX_TOL)
    y0, aux0 = tmoe.moe_ffn(pt, _t(x), cfg, "silu", cap_mode)
    assert aux0 is None and torch.equal(y0, y)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


# aten ops of one prefill (2 x 4 tokens, max_seq 16) and one decode step
# of the reduced models on the tree before the aux loss existed
SERVING_OPS = {"mixtral-8x22b": (492, 459), "qwen2-moe-a2.7b": (514, 483)}


@pytest.mark.parametrize("name", sorted(SERVING_OPS))
def test_serving_passes_issue_no_aux_ops(name, monkeypatch):
    """prefill and decode_step never compute the load-balance loss: with
    it made to raise they still run, and they issue as many ops as
    before it existed."""
    def refuse(*a, **kw):
        raise AssertionError("load_balance_loss on a serving path")
    monkeypatch.setattr(tmoe, "load_balance_loss", refuse)
    cfg = tconfig.reduced(tconfig.get_config(name))
    params = ttf.init_params(cfg, 0, device="cpu")
    prompt, tok = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 10]]), torch.tensor([3, 4])
    pos = torch.tensor([4, 4], dtype=torch.int32)
    with _CountOps() as pre:
        _, cache = ttf.prefill(params, cfg, prompt, max_seq=16)
    with _CountOps() as dec:
        ttf.decode_step(params, cfg, tok, cache, pos)
    assert (len(pre.ops), len(dec.ops)) == SERVING_OPS[name]


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "whisper-large-v3"])
def test_forward_hidden_and_forward_train_match_jax(jx, name):
    from repro.models import stubs as jstubs
    jcfg, tcfg, pj, pn = _model(jx, name)
    pt = params_from_jax(pn, tcfg, device="cpu")
    toks = np.random.RandomState(1).randint(0, tcfg.vocab, (2, 12)).astype(np.int32)
    ex = {k: np.asarray(v) for k, v in jstubs.extra_inputs(jcfg, 2).items()}
    ext = {k: _t(v) for k, v in ex.items()}
    hj, auxj = jx.tf.forward_hidden(pj, jcfg, jx.jnp.asarray(toks), remat="none", **ex)
    ht, auxt = ttf.forward_hidden(pt, tcfg, _t(toks), remat="none", **ext)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **LOGIT_TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **AUX_TOL)
    assert (float(auxt) > 0) == (tcfg.moe is not None)
    lj, _ = jx.tf.forward_train(pj, jcfg, jx.jnp.asarray(toks), remat="none", **ex)
    lt, auxt2 = ttf.forward_train(pt, tcfg, _t(toks), **ext)    # remat "full"
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert float(auxt2) == float(auxt)


def test_chunked_xent_matches_full():
    """Any chunk (one that does not divide B * T shrinks to one that
    does) gives the full log-softmax loss."""
    cfg = tconfig.reduced(tconfig.get_config("qwen2-moe-a2.7b"))
    params = ttf.init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2))
    hidden, _ = ttf.forward_hidden(params, cfg, toks[:, :-1], remat="none")
    logits, _ = ttf.forward_train(params, cfg, toks[:, :-1], remat="none")
    lp = torch.log_softmax(logits.float(), -1)
    want = -lp.gather(-1, toks[:, 1:, None].long()).mean()
    for chunk in (4, 7, 1024):
        got = tloop.chunked_xent(params, cfg, hidden, toks[:, 1:], chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_remat_changes_what_backward_recomputes_not_values():
    """Matmuls run in backward: "none" only the gradient ones, "full"
    also every forward one of the block periods again, "dots" the
    batched ones (``bmm``: attention, the experts) again but no 2-D
    ``mm`` (those it saved).  Loss and gradients equal in all three."""
    cfg = tconfig.reduced(tconfig.get_config("mixtral-8x22b"))
    toks = torch.randint(0, cfg.vocab, (2, 13), generator=torch.Generator().manual_seed(4))
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    runs = {}
    for remat in ("none", "full", "dots"):
        params = ttf.init_params(cfg, 0, device="cpu")
        for p in topt.leaves(params):
            p.requires_grad_(True)
        with _CountOps() as fwd:
            hidden, aux = ttf.forward_hidden(params, cfg, toks, remat=remat)
        loss = (hidden.float().square().mean() + aux)
        with _CountOps() as bwd:
            loss.backward()
        grads = [p.grad for p in topt.leaves(params) if p.grad is not None]
        runs[remat] = (loss.item(), grads,
                       {op: fwd.ops.count(op) for op in (mm, bmm)},
                       {op: bwd.ops.count(op) for op in (mm, bmm)})
    f_none, b_none = runs["none"][2], runs["none"][3]
    assert runs["full"][3][mm] == b_none[mm] + f_none[mm]
    assert runs["full"][3][bmm] == b_none[bmm] + f_none[bmm]
    assert runs["dots"][3][mm] == b_none[mm]
    assert runs["dots"][3][bmm] == b_none[bmm] + f_none[bmm]
    for remat in ("full", "dots"):
        assert runs[remat][0] == runs["none"][0]
        assert len(runs[remat][1]) == len(runs["none"][1]) > 0
        for a, b in zip(runs[remat][1], runs["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


# -------------------------------------------------------------- optimizer
def test_cosine_lr_matches_jax(jx):
    for cfg in (topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                                 min_lr_ratio=0.1),
                topt.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)):
        jcfg = jx.opt.AdamWConfig(**{f: getattr(cfg, f) for f in
                                     cfg.__dataclass_fields__})
        for s in (0, 1, 2, 5, 9, 10, 11, 60, 110, 200):
            np.testing.assert_allclose(
                float(topt.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))),
                float(jx.opt.cosine_lr(jcfg, jx.jnp.asarray(s, jx.jnp.int32))),
                **OPT_TOL)
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
    assert float(topt.cosine_lr(cfg, 5)) == pytest.approx(0.5)
    assert float(topt.cosine_lr(cfg, 10)) == pytest.approx(1.0)
    assert float(topt.cosine_lr(cfg, 110)) == pytest.approx(0.1)


@pytest.mark.parametrize("moment_dtype,grad_scale", [
    ("float32", 0.01), ("float32", 10.0), ("bfloat16", 10.0)])
def test_adamw_update_matches_jax(jx, moment_dtype, grad_scale):
    """One update from the same params, grads and state (step 3): a
    matrix, a 3-D leaf, a vector and a scalar (the last two not
    decayed); grad_scale 10 puts the global norm past the clip."""
    rng = np.random.RandomState(7)
    shapes = {"w": (8, 6), "e": (2, 4, 3), "b": (6,), "g": ()}
    r = lambda s, a=1.0: np.asarray(rng.randn(*s) * a, np.float32)
    params = {k: r(s) for k, s in shapes.items()}
    grads = {k: r(s, grad_scale) for k, s in shapes.items()}
    mu = {k: r(s, 0.1) for k, s in shapes.items()}
    nu = {k: np.abs(r(s, 0.1)) for k, s in shapes.items()}
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20,
                           moment_dtype=moment_dtype)
    jcfg = jx.opt.AdamWConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jdt = getattr(jx.jnp, moment_dtype)
    tdt = getattr(torch, moment_dtype)
    jstate = jx.opt.OptState(jx.jnp.asarray(3, jx.jnp.int32),
                             {k: jx.jnp.asarray(v, jdt) for k, v in mu.items()},
                             {k: jx.jnp.asarray(v, jdt) for k, v in nu.items()})
    pj, sj, mj = jx.opt.adamw_update(
        jcfg, {k: jx.jnp.asarray(v) for k, v in params.items()},
        {k: jx.jnp.asarray(v) for k, v in grads.items()}, jstate)
    tstate = topt.OptState(
        torch.tensor(3, dtype=torch.int32),
        *({k: _t(np.asarray(v, np.float32)).to(tdt) for k, v in t.items()}
          for t in (jstate.mu, jstate.nu)))
    assert tstate.mu["w"].dtype == tdt
    pt = {k: _t(v) for k, v in params.items()}
    pt2, st, mt = topt.adamw_update(cfg, pt, {k: _t(v) for k, v in grads.items()},
                                    tstate)
    assert pt2 is pt and int(st.step) == 4
    assert (float(mj["grad_norm"]) > 1.0) == (grad_scale > 1.0)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), **OPT_TOL)
    np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), **OPT_TOL)
    for k in shapes:
        np.testing.assert_allclose(_np(pt[k]), np.asarray(pj[k]), **OPT_TOL, err_msg=k)
        for got, want in ((st.mu[k], sj.mu[k]), (st.nu[k], sj.nu[k])):
            assert got.dtype == tdt
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                       **OPT_TOL, err_msg=k)
    # the vector and the scalar took no decay: with zero moments and
    # zero gradients the update leaves them exactly as they were
    zero = {k: torch.zeros(s) for k, s in shapes.items()}
    p0 = {k: _t(v) for k, v in params.items()}
    topt.adamw_update(cfg, p0, {k: v.clone() for k, v in zero.items()},
                      topt.init_opt_state(p0))
    for k in ("b", "g"):
        assert torch.equal(p0[k], _t(params[k])), k
    for k in ("w", "e"):
        assert not torch.equal(p0[k], _t(params[k])), k


def test_opt_state_from_jax_unstacks_like_the_params(jx):
    jcfg, tcfg, pj, pn = _model(jx, "mixtral-8x22b")
    grads = jx.jax.tree.map(lambda a: jx.jnp.ones_like(a) * 0.01, pj)
    _, sj, _ = jx.opt.adamw_update(jx.opt.AdamWConfig(), pj, grads,
                                   jx.opt.init_opt_state(pj))
    st = opt_state_from_jax(jx.jax.tree.map(np.asarray, sj), tcfg, device="cpu")
    assert isinstance(st, topt.OptState) and st.step.dtype == torch.int32
    assert int(st.step) == 1
    for got, want in ((st.mu, sj.mu), (st.nu, sj.nu)):
        want_t = dict(topt.named_leaves(params_from_jax(
            jx.jax.tree.map(np.asarray, want), tcfg, device="cpu")))
        got_t = dict(topt.named_leaves(got))
        assert got_t.keys() == want_t.keys()
        for k in got_t:
            assert torch.equal(got_t[k], want_t[k]), k
        assert len(got["layers"]) == tcfg.n_layers


@pytest.mark.parametrize("fid", ["recurrentgemma-2b+remainder", "mamba2-1.3b",
                                 "whisper-large-v3", "llama-3.2-vision-90b"])
def test_decay_mask_is_the_jax_rule_on_the_stacked_tree(jx, fid):
    """``decay_mask`` takes, for every leaf of the port's unstacked
    params, the decision JAX's ``ndim >= 2`` takes on the stacked leaf
    it came from: each JAX leaf filled with its decision and carried
    across by the bridge gives the mask back."""
    name, remainder = FAMILIES[fid]
    jcfg, tcfg = _configs(jx, name, remainder)
    pn = jx.jax.tree.map(np.asarray, jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0)))
    want = params_from_jax(jx.jax.tree.map(lambda a: np.full(a.shape, a.ndim >= 2), pn),
                           tcfg, device="cpu")
    got = topt.decay_mask(params_from_jax(pn, tcfg, device="cpu"), tcfg)
    want = [bool(t.reshape(-1)[0]) for t in topt.leaves(want)]
    assert got == want
    assert not all(got) and any(   # vectors of stacked layers decay
        g and t.ndim == 1 for g, t in zip(got, topt.leaves(
            params_from_jax(pn, tcfg, device="cpu"))))


@pytest.mark.parametrize("fid", ["mamba2-1.3b", "recurrentgemma-2b+remainder",
                                 "whisper-large-v3"])
def test_adamw_update_of_a_model_tree_matches_jax(jx, fid):
    """One update of a model's param tree from the same params,
    gradients and state (step 3, all drawn with numpy): the JAX update on its
    stacked tree, the port's on the unstacked one with the model's
    ``decay_mask``, every leaf within 1e-6 of its max |p| (p - lr * delta
    cancels to near 0 at some elements, so a bound relative to each
    element would hold rounding to more than f32 has).  The default rule
    (a leaf's own ndim) decays no vector of a stacked block and misses
    JAX."""
    jcfg, tcfg = _configs(jx, *FAMILIES[fid])
    pn = jx.jax.tree.map(np.asarray, jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0)))
    rng = np.random.RandomState(2)
    draw = lambda a, s: np.asarray(rng.randn(*a.shape) * s, np.float32)
    pn = jx.jax.tree.map(lambda a: draw(a, 1.0), pn)     # no leaf at 0
    grads = jx.jax.tree.map(lambda a: draw(a, 0.01), pn)
    mu = jx.jax.tree.map(lambda a: draw(a, 1e-3), pn)
    nu = jx.jax.tree.map(lambda a: np.abs(draw(a, 1e-4)), pn)
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    jcfg_opt = jx.opt.AdamWConfig(**{f: getattr(cfg, f) for f in
                                     cfg.__dataclass_fields__})
    to_j = lambda t: jx.jax.tree.map(jx.jnp.asarray, t)
    pj, sj, _ = jx.opt.adamw_update(jcfg_opt, to_j(pn), to_j(grads), jx.opt.OptState(
        jx.jnp.asarray(3, jx.jnp.int32), to_j(mu), to_j(nu)))
    want = topt.leaves(params_from_jax(jx.jax.tree.map(np.asarray, pj), tcfg,
                                       device="cpu"))
    state = (jx.jnp.asarray(3, jx.jnp.int32), mu, nu)
    for decay, same in (("mask", True), (None, False)):
        pt = params_from_jax(pn, tcfg, device="cpu")
        mask = topt.decay_mask(pt, tcfg) if decay else None
        topt.adamw_update(cfg, pt, topt.leaves(params_from_jax(grads, tcfg, device="cpu")),
                          opt_state_from_jax(state, tcfg, device="cpu"), decay=mask)
        ok = [np.abs(_np(a) - _np(b)).max() <= 1e-6 * np.abs(_np(b)).max()
              for a, b in zip(topt.leaves(pt), want)]
        assert all(ok) if same else not all(ok), decay


# ------------------------------------------------------------- data, ckpt
def test_synthetic_lm_batches_equal_jax(jx):
    for c in (dict(vocab=100, seq_len=64, batch=4, seed=11),
              dict(vocab=32000, seq_len=129, batch=8, seed=0)):
        got = SyntheticLM(DataConfig(**c)).batches(3)
        want = jx.data.SyntheticLM(jx.data.DataConfig(**c)).batches(3)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trip_prune_and_latest(tmp_path):
    """bf16 params and moments come back bit for bit, f32 exact; keep
    prunes to the newest; latest_step reads the newest directory."""
    cfg = tconfig.reduced(tconfig.get_config("qwen2-moe-a2.7b"))
    params = ttf.init_params(cfg, 0, torch.bfloat16, device="cpu")
    params["final_norm"] = params["final_norm"].float()      # a mixed tree
    opt = topt.init_opt_state(params, "bfloat16")
    opt.mu["embed"].normal_(generator=torch.Generator().manual_seed(1))
    opt = topt.OptState(torch.tensor(9, dtype=torch.int32), opt.mu, opt.nu)
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    tckpt.save(d, 7, params, opt)
    tckpt.save(d, 8, params, opt, extra={"note": "x"})
    tmpl_p = topt.tree_map(torch.zeros_like, params)
    tmpl_o = topt.init_opt_state(params, "bfloat16")
    p2, o2, step = tckpt.restore(d, tmpl_p, tmpl_o)
    assert step == 8 and int(o2.step) == 9
    for (k, a), (_, b) in zip(topt.named_leaves(params), topt.named_leaves(p2)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), k
    for a, b in zip(topt.leaves(opt.mu), topt.leaves(o2.mu)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.restore(d, {"embed": tmpl_p["embed"]})
    for s in range(6):
        tckpt.save(d, s + 10, params, keep=3)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000013", "step_00000014", "step_00000015"]
    assert tckpt.latest_step(d) == 15
    assert sorted(p.name for p in (tmp_path / "ck" / "step_00000015").iterdir()) == [
        "manifest.json", "params.npz"]


# ----------------------------------------------------------------- train
# (config, whether every element is held to 1e-4 of its leaf's max |p|)
TRAIN_CASES = [("mixtral-8x22b", True), ("mamba2-1.3b", False),
               ("recurrentgemma-2b+remainder", False)]


@pytest.mark.parametrize("fid,each_element", TRAIN_CASES)
def test_three_train_steps_match_jax(jx, tmp_path, fid, each_element):
    """``train`` from the same params over the same batches: every loss
    within 1e-4, and the params after the last step (JAX's from its own
    checkpoint) against each leaf's max |p|.

    mamba2's ``A_log``, ``D`` and ``dt_bias`` start away from 0, so a
    weight decay other than JAX's on a stacked block's vectors shifts
    all their elements.  Its SSD and recurrentgemma's RG-LRU sum their
    recurrences in another order than JAX's scans, and AdamW's first
    step moves an element by nearly +-lr whatever its gradient, so an
    element whose gradient is ~0 lands where the last bits of its sum
    put it.  Such noise is measured in steps, not in |p| (a leaf that
    starts at 0 ends near sum(lr)).  For those two each leaf's mean error
    is held within 1e-3 of sum(lr), the furthest AdamW's three steps move
    an element (a decay of wd * lr * |p| per step missing from an O(1)
    vector errs by 0.1 of it), and each element within what AdamW can
    move two runs apart, 2 * sum(lr) * (1 + wd * |p|); mixtral's every
    element within 1e-4 of its leaf's max |p|."""
    jcfg, tcfg = _configs(jx, *FAMILIES.get(fid, (fid, None)))
    pj = jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))
    pn = jx.jax.tree.map(np.asarray, pj)
    dc = dict(vocab=tcfg.vocab, seq_len=17, batch=4, seed=5)
    jo = jx.opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    rj = jx.loop.train(jcfg, pj, jx.data.SyntheticLM(jx.data.DataConfig(**dc)),
                       steps=3, opt_cfg=jo, log_every=0,
                       checkpoint_dir=str(tmp_path / "j"), checkpoint_every=3)
    pt = params_from_jax(pn, tcfg, device="cpu")
    to = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    rt = tloop.train(tcfg, pt, SyntheticLM(DataConfig(**dc)), steps=3,
                     opt_cfg=to, log_every=0, checkpoint_dir=str(tmp_path / "t"),
                     checkpoint_every=3, device="cpu")
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-4)
    assert rt.losses[-1] < rt.losses[0] and rt.steps == 3
    jp, _, step = jx.ckpt.restore(str(tmp_path / "j"), pj)
    assert step == 3
    want = dict(topt.named_leaves(params_from_jax(
        jx.jax.tree.map(np.asarray, jp), tcfg, device="cpu")))
    lr_sum = sum(float(topt.cosine_lr(to, s)) for s in (1, 2, 3))
    for k, p in topt.named_leaves(pt):
        w = want[k].numpy()
        err, scale = np.abs(p.detach().numpy() - w), float(np.abs(w).max())
        if each_element:
            assert err.max() <= 1e-4 * scale, (k, float(err.max()))
        else:
            assert err.mean() <= 1e-3 * lr_sum, (k, float(err.mean()))
            assert (err <= 2 * lr_sum * (1 + to.weight_decay * np.abs(w))).all(), k
        assert p.grad is None and p.requires_grad, k
    saved, _, _ = tckpt.restore(str(tmp_path / "t"), pt)
    for a, b in zip(topt.leaves(saved), topt.leaves(pt)):
        assert torch.equal(a, b.detach())


def test_loss_decreases_dense():
    """The port's counterpart of the JAX package's
    ``test_loss_decreases_dense``: 30 steps of reduced minitron-4b."""
    cfg = tconfig.reduced(tconfig.get_config("minitron-4b"))
    params = ttf.init_params(cfg, 1, device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, batch=8, seed=3))
    res = tloop.train(cfg, params, data, steps=30, log_every=0, device="cpu",
                      opt_cfg=topt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                               total_steps=30))
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.2, (first, last)


@pytest.mark.parametrize("arch", ["minitron-4b", "whisper-large-v3"])
def test_launch_train_on_the_cpu(arch, capsys):
    from repro_torch.launch.train import main
    losses = main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                   "--batch", "2", "--seq", "16", "--remat", "full"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "trained 3 steps in" in out


def test_launch_train_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "minitron-4b", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------- kernels
def test_kernel_guard_refuses_inputs_that_require_grad():
    """The guard the CUDA routes call: an input that requires grad is
    refused while grad mode is on, accepted under ``no_grad``; the plain
    routes stay differentiable."""
    a, b = torch.ones(2, requires_grad=True), torch.ones(2)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_build.check_no_grad("k", b, None, a)
    cuda_build.check_no_grad("k", b, None)
    with torch.no_grad():
        cuda_build.check_no_grad("k", a)
    from repro_torch.kernels import ops as kops
    x = torch.randn(2, 3, 4, requires_grad=True)
    kops.grouped_matmul(x, torch.randn(2, 4, 5)).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
