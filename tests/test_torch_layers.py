"""Parity of the PyTorch port's model layers with the JAX package, on the
CPU at reduced sizes.

Inputs are made with numpy from a seed and fed to both packages (JAX
params go to the port through ``repro_torch.bridge``).  Tolerances:
  * building blocks, attention and MoE values: rtol = atol = 1e-5 in f32
    (same math, different summation order);
  * routing indices and dispatch buffers: exact;
  * prefill / decode_step logits: rtol = atol = 5e-4 (the JAX package's
    runtime-parity tolerance, ``tests/test_disagg_kernels.py``), greedy
    tokens identical.
The JAX-dependent cases get JAX through a fixture that skips where JAX
is not installed, so the file also collects on a machine without it.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import config as jconfig
    from repro.models import attention as jattn
    from repro.models import common as jcommon
    from repro.models import moe as jmoe
    from repro.models import transformer as jtf
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig, attn=jattn,
                                 common=jcommon, moe=jmoe, tf=jtf)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got).astype(np.float32),
                               np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ["mixtral-8x22b", "dbrx", "scaled-moe"])
def test_configs_match_jax(jx, name):
    """Full and reduced configs carry the same fields in both packages."""
    for red in (False, True):
        jc = jx.config.get_config(name)
        tc = tconfig.get_config(name)
        if red:
            jc, tc = jx.config.reduced(jc), tconfig.reduced(tc)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "vocab", "block_pattern", "window", "act", "rope_theta",
                  "tie_embeddings", "attn_softcap", "logit_softcap"):
            assert getattr(jc, f) == getattr(tc, f), f
        for f in ("n_experts", "top_k", "d_ff_expert", "capacity_factor"):
            assert getattr(jc.moe, f) == getattr(tc.moe, f), f


# ------------------------------------------------------------ common
def test_common_blocks_match_jax(jx):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 64).astype(np.float32)
    scale = rng.randn(64).astype(np.float32) * 0.1
    pos = rng.randint(0, 100, size=(2, 5)).astype(np.int32)
    _close(tcommon.rms_norm(_t(x), _t(scale)), jx.common.rms_norm(x, scale))
    _close(tcommon.apply_rope(_t(x), _t(pos), 10000.0),
           jx.common.apply_rope(x, pos, 10000.0))
    _close(tcommon.softcap(_t(x) * 30, 20.0), jx.common.softcap(x * 30, 20.0))
    for act in ("silu", "gelu"):
        _close(tcommon.activation(_t(x), act), jx.common.activation(x, act))


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 30.0)])
def test_prefill_attention_matches_jax(jx, window, cap):
    rng = np.random.RandomState(1)
    B, S, H, Hkv, hd = 2, 9, 4, 2, 64
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, Hkv, hd).astype(np.float32)
    v = rng.randn(B, S, Hkv, hd).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    pos[1, :2] = -1                                     # invalid slots
    kw = dict(window=window, attn_softcap=cap)
    got = tattn.attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), q_chunk=4, **kw)
    a = jx.jnp.asarray
    want = jx.attn.attention(a(q), a(k), a(v), a(pos), a(pos), **kw)
    _close(got, want)


# ------------------------------------------------------------ moe
def _routing_case(T=24, d=32, E=8, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, d).astype(np.float32),
            rng.randn(d, E).astype(np.float32),
            rng.randn(E).astype(np.float32))


@pytest.mark.parametrize("cap_mode", ["full", "eval", "train"])
def test_route_and_dispatch_match_jax(jx, cap_mode):
    x, w, bias = _routing_case()
    E, K = w.shape[1], 2
    cfg = tconfig.MoEConfig(n_experts=E, top_k=K, d_ff_expert=16)
    C = tmoe.expert_capacity(x.shape[0], cfg, cap_mode)
    assert C == jx.moe.expert_capacity(x.shape[0], cfg, cap_mode)
    rt = tmoe.route(_t(x), _t(w), K, _t(bias))
    rj = jx.moe.route(x, w, K, bias)
    np.testing.assert_array_equal(_np(rt.experts), np.asarray(rj.experts))
    _close(rt.gates, rj.gates)
    it, gt = tmoe.dispatch_indices(rt, E, C)
    ij, gj = jx.moe.dispatch_indices(rj, E, C)
    np.testing.assert_array_equal(_np(it), np.asarray(ij))
    _close(gt, gj)
    cw = (np.arange(x.shape[0]) % 3 > 0).astype(np.float32)
    _close(tmoe.routing_counts(rt, E, _t(cw)), jx.moe.routing_counts(rj, E, cw))


def test_token_hash_and_replica_assign_match_jax(jx):
    """The uint32 splitmix hash done in int64 is bit-identical."""
    from repro.core import load_balance as lb
    ids = np.concatenate([np.arange(4096), [2 ** 31 - 1, 123456789]]).astype(np.int32)
    np.testing.assert_array_equal(_np(tmoe.token_hash01(_t(ids))),
                                  np.asarray(jx.moe._token_hash01(ids)))
    x, w, _ = _routing_case(T=64, seed=5)
    tbl = lb.placement_tables(lb.balance_experts([100.0] + [4.0] * 7, 4), 4)
    rj = jx.moe.route(x, w, 2)
    vj, nj = jx.moe.replica_assign(rj.experts, tbl.rep_node, tbl.rep_slot,
                                   tbl.rep_cum, slots_per_node=4)
    vt, nt = tmoe.replica_assign(_t(np.asarray(rj.experts)), _t(tbl.rep_node),
                                 _t(tbl.rep_slot), _t(tbl.rep_cum), 4)
    np.testing.assert_array_equal(_np(vt), np.asarray(vj))
    np.testing.assert_array_equal(_np(nt), np.asarray(nj))


def test_topk_ties_take_lowest_index():
    probs = torch.tensor([[0.1, 0.3, 0.2, 0.3, 0.1],
                          [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = tmoe.topk_lowest_index(probs, 3)
    assert idx.tolist() == [[1, 3, 2], [0, 1, 2]]
    assert vals[0].tolist() == pytest.approx([0.3, 0.3, 0.2])


@pytest.mark.parametrize("cap_mode,extras", [("full", False), ("eval", False),
                                             ("full", True)])
def test_moe_ffn_matches_jax(jx, cap_mode, extras):
    """Routed experts, plus (extras) qwen2-moe shared experts and the
    arctic dense residual."""
    rng = np.random.RandomState(3)
    T, d, E, f = 16, 32, 4, 48
    cfg = tconfig.MoEConfig(n_experts=E, top_k=2, d_ff_expert=f)
    r = lambda *s: rng.randn(*s).astype(np.float32) * 0.2
    p = {"router": r(d, E) * 5, "we1": r(E, d, f), "we3": r(E, d, f),
         "we2": r(E, f, d)}
    if extras:
        p.update(ws1=r(d, f), ws3=r(d, f), ws2=r(f, d), shared_gate=r(d),
                 wd1=r(d, f), wd3=r(d, f), wd2=r(f, d))
    x = rng.randn(T, d).astype(np.float32)
    got, aux = tmoe.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                            "silu", cap_mode)
    assert aux is None
    want, _ = jx.moe.moe_ffn({k: jx.jnp.asarray(v) for k, v in p.items()},
                             jx.jnp.asarray(x), cfg, "silu", cap_mode)
    _close(got, want)


# ------------------------------------------------------------ transformer
@pytest.fixture(scope="module", params=["mixtral-8x22b", "dbrx"])
def model(request, jx):
    name = request.param
    jcfg = jx.config.reduced(jx.config.get_config(name))
    tcfg = tconfig.reduced(tconfig.get_config(name))
    params_j = jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))
    params_t = params_from_jax(jx.jax.tree.map(np.asarray, params_j), tcfg,
                               device="cpu")
    return jcfg, tcfg, params_j, params_t


def test_bridge_unstacks_layers(model):
    jcfg, tcfg, params_j, params_t = model
    assert len(params_t["layers"]) == tcfg.n_layers
    for l, lp in enumerate(params_t["layers"]):
        for k, v in lp.items():
            np.testing.assert_array_equal(_np(v),
                                          np.asarray(params_j["blocks"][0][k][l]))


def test_prefill_and_decode_match_jax(jx, model):
    """prefill logits and cache, then three greedy decode steps: logits
    at 5e-4 and identical tokens; the port's cache (written in place)
    equals JAX's rebuilt cache."""
    jcfg, tcfg, params_j, params_t = model
    rng = np.random.RandomState(4)
    B, T, max_seq = 2, 6, 16
    toks = rng.randint(0, tcfg.vocab, size=(B, T)).astype(np.int32)
    lj, cj = jx.tf.prefill(params_j, jcfg, jx.jnp.asarray(toks), max_seq=max_seq)
    lt, ct = ttf.prefill(params_t, tcfg, _t(toks), max_seq=max_seq)
    _close(lt, lj, LOGIT_TOL)
    ct_j = cache_from_jax(jx.jax.tree.map(np.asarray, cj), tcfg, device="cpu")
    for a, b in zip(ct, ct_j):
        np.testing.assert_array_equal(_np(a["pos"]), _np(b["pos"]))
        _close(a["k"], _np(b["k"]), LOGIT_TOL)
    nxt = np.asarray(jx.jnp.argmax(lj, -1)).astype(np.int32)
    np.testing.assert_array_equal(_np(torch.argmax(lt, -1)), nxt)
    pos = np.full((B,), T, np.int32)
    nj, nt = nxt, _t(nxt)
    for _ in range(3):
        lj, cj = jx.tf.decode_step(params_j, jcfg, jx.jnp.asarray(nj), cj,
                                   jx.jnp.asarray(pos))
        lt, ct = ttf.decode_step(params_t, tcfg, nt, ct, _t(pos))
        _close(lt, lj, LOGIT_TOL)
        nj = np.asarray(jx.jnp.argmax(lj, -1)).astype(np.int32)
        nt = torch.argmax(lt, -1)
        np.testing.assert_array_equal(_np(nt), nj)
        pos = pos + 1
    ct_j = cache_from_jax(jx.jax.tree.map(np.asarray, cj), tcfg, device="cpu")
    for a, b in zip(ct, ct_j):
        np.testing.assert_array_equal(_np(a["pos"]), _np(b["pos"]))
        _close(a["v"], _np(b["v"]), LOGIT_TOL)


def test_local_layers_use_a_window_ring():
    """A ``local`` layer's cache is min(window, max_seq) wide and the ring
    slot is pos % W."""
    cfg = tconfig.reduced(tconfig.get_config("mixtral-8x22b"))
    import dataclasses
    cfg = dataclasses.replace(cfg, block_pattern=("local",), window=4)
    params = ttf.init_params(cfg, 0, device="cpu")
    cache = ttf.init_cache(cfg, 1, 16, device="cpu")
    assert cache[0]["k"].shape[1] == 4
    tok = torch.tensor([3])
    for p in range(6):
        ttf.decode_step(params, cfg, tok, cache, torch.tensor([p], dtype=torch.int32))
    assert sorted(cache[0]["pos"][0].tolist()) == [2, 3, 4, 5]
    assert cache[0]["pos"][0, 5 % 4].item() == 5


# ------------------------------------------------------------ isolation
def test_port_imports_nothing_of_jax():
    """Every module of repro_torch (and chip_smoke.py) imports, in a fresh
    interpreter, with neither jax nor any module of the JAX package.  The
    paged serving modules, the prefill worker, the stats schema, the
    gating_topk kernel and the m2n, transport, load-balance and
    ping-pong modules, the model families (RG-LRU, SSD, stubs), the
    registry's configs, the planner and the trainer are named, so the
    check fails if the walk stops reaching them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('serving.pages', 'serving.prefix_cache', 'serving.prefill',\n"
        "          'serving.stats', 'kernels.gating_topk', 'core.m2n',\n"
        "          'core.transport', 'core.load_balance', 'core.pingpong',\n"
        "          'core.planner', 'models.rglru', 'models.ssd', 'models.stubs',\n"
        "          'configs.recurrentgemma_2b', 'configs.mamba2_13b',\n"
        "          'configs.whisper_large_v3', 'configs.llama_3_2_vision_90b',\n"
        "          'configs.qwen2_moe_a27b', 'configs.arctic_480b',\n"
        "          'configs.gemma2_27b', 'configs.granite_3_8b',\n"
        "          'configs.minitron_4b', 'configs.minitron_8b',\n"
        "          'training.data', 'training.optimizer', 'training.loop',\n"
        "          'training.checkpoint', 'launch.train'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    root = os.path.dirname(SRC)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + root)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 34


def test_entry_points_default_to_cuda():
    """Without ``device=``, entry points ask for the card: on a machine
    without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = tconfig.reduced(tconfig.get_config("mixtral-8x22b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_cache(cfg, 2, 16)
    from repro_torch.serving.engine import Engine
    params = ttf.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    from repro_torch.launch.serve import build
    from repro_torch.serving.config import ServingConfig
    with pytest.raises(RuntimeError, match="CUDA"):
        build(ServingConfig(runtime="pingpong", microbatches="auto",
                            prefill_devices=1))
