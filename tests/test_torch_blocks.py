"""The port's RG-LRU, SSD and cross-attention blocks against the JAX
package, on the CPU in f32.

Inputs are made with numpy from a seed and fed to both packages.
Tolerance: rtol = atol = 1e-5.  The math is the same; the order of the
sums is not: the JAX package runs the RG-LRU recurrence and the SSD
recurrence over chunk states as ``associative_scan`` trees, the port as
loops over time (or chunks), and einsum contractions may pair their
products differently.  Both are f32, so they agree to f32 rounding.
The masks are exact: ``segsum``'s -inf entries must be in the same
places, and ``exp`` of them exact zeros.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.config import RGLRUConfig, SSMConfig
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import rglru as trg
from repro_torch.models import ssd as tssd

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import config as jconfig
    from repro.models import attention as jattn
    from repro.models import common as jcommon
    from repro.models import rglru as jrg
    from repro.models import ssd as jssd
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig, attn=jattn,
                                 common=jcommon, rg=jrg, ssd=jssd)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got).astype(np.float32),
                               np.asarray(want, np.float32), **tol)


def _r(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------------ RG-LRU
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_recurrence_matches_jax(jx, with_h0):
    rng = np.random.RandomState(0)
    a = rng.uniform(0.5, 1.0, size=(2, 13, 24)).astype(np.float32)
    b = _r(rng, 2, 13, 24)
    h0 = _r(rng, 2, 24) if with_h0 else None
    got = trg.linear_recurrence(_t(a), _t(b), None if h0 is None else _t(h0))
    want = jx.rg.linear_recurrence(jx.jnp.asarray(a), jx.jnp.asarray(b),
                                   None if h0 is None else jx.jnp.asarray(h0))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_jax(jx, with_cache):
    rng = np.random.RandomState(1)
    x, w = _r(rng, 2, 7, 16), _r(rng, 4, 16, scale=0.5)
    cache = _r(rng, 2, 3, 16) if with_cache else None
    got = trg.causal_conv1d(_t(x), _t(w), None if cache is None else _t(cache))
    want = jx.rg.causal_conv1d(x, w, cache)
    _close(got[0], want[0])
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def _rglru_params(rng, d, w):
    return {"w_in_x": _r(rng, d, w, scale=d ** -0.5),
            "w_in_gate": _r(rng, d, w, scale=d ** -0.5),
            "conv_w": _r(rng, 4, w, scale=0.5),
            "w_a": _r(rng, w, w, scale=w ** -0.5), "b_a": _r(rng, w, scale=0.1),
            "w_x": _r(rng, w, w, scale=w ** -0.5), "b_x": _r(rng, w, scale=0.1),
            "lam": np.full((w,), 0.5, np.float32) + _r(rng, w, scale=0.1),
            "w_out": _r(rng, w, d, scale=w ** -0.5)}


def test_rglru_scan_and_step_match_jax(jx):
    """rglru_scan against JAX's, and against the port's rglru_step walked
    over the same sequence."""
    rng = np.random.RandomState(2)
    cfg = RGLRUConfig(lru_width=32)
    p = _rglru_params(rng, 16, 32)
    u, h0 = _r(rng, 2, 9, 32), _r(rng, 2, 32)
    tp = {k: _t(v) for k, v in p.items()}
    got_h, got_last = trg.rglru_scan(_t(u), tp, cfg, _t(h0))
    want_h, want_last = jx.rg.rglru_scan(u, p, jx.config.RGLRUConfig(32), h0)
    _close(got_h, want_h)
    _close(got_last, want_last)
    h = _t(h0)
    for t in range(u.shape[1]):
        out, h = trg.rglru_step(_t(u[:, t]), tp, cfg, h)
        _close(out, want_h[:, t])
        w_out, _ = jx.rg.rglru_step(u[:, t], p, jx.config.RGLRUConfig(32),
                                    np.asarray(want_h[:, t - 1]) if t else h0)
        _close(out, w_out)
    _close(h, want_last)


def test_rglru_block_and_step_match_jax(jx):
    rng = np.random.RandomState(3)
    d, w = 16, 32
    cfg, jcfg = RGLRUConfig(lru_width=w), jx.config.RGLRUConfig(lru_width=w)
    p = _rglru_params(rng, d, w)
    tp = {k: _t(v) for k, v in p.items()}
    x = _r(rng, 2, 6, d)
    tgelu = lambda t: tcommon.activation(t, "gelu")
    jgelu = lambda t: jx.common.activation(t, "gelu")
    y, st = trg.rglru_block(tp, _t(x), cfg, tgelu)
    yj, stj = jx.rg.rglru_block(p, x, jcfg, jgelu)
    _close(y, yj)
    _close(st["h"], stj["h"])
    _close(st["conv"], stj["conv"])
    xs = _r(rng, 2, d)
    y1, st1 = trg.rglru_block_step(tp, _t(xs), cfg, tgelu, st)
    yj1, stj1 = jx.rg.rglru_block_step(p, xs, jcfg, jgelu, stj)
    _close(y1, yj1)
    _close(st1["h"], stj1["h"])
    _close(st1["conv"], stj1["conv"])


# ------------------------------------------------------------ SSD
def test_segsum_matches_jax(jx):
    rng = np.random.RandomState(4)
    x = _r(rng, 2, 3, 11, scale=0.3)
    got, want = tssd.segsum(_t(x)), np.asarray(jx.ssd.segsum(x))
    np.testing.assert_array_equal(np.isneginf(_np(got)), np.isneginf(want))
    fin = np.isfinite(want)
    _close(_np(got)[fin], want[fin])
    e = torch.exp(got)
    assert not torch.isnan(e).any()
    assert (e[..., ~torch.tril(torch.ones(11, 11, dtype=torch.bool))] == 0).all()


@pytest.mark.parametrize("l,with_state", [(37, False), (37, True), (32, True)])
def test_ssd_chunked_matches_jax(jx, l, with_state):
    """Chunk 16: 37 tokens pad to 48, whose final state must still be
    the JAX one; 32 is two whole chunks."""
    rng = np.random.RandomState(5)
    b, h, p, n = 2, 3, 8, 5
    x = _r(rng, b, l, h, p)
    dtA = -rng.uniform(0.01, 0.5, size=(b, l, h)).astype(np.float32)
    B, C = _r(rng, b, l, n), _r(rng, b, l, n)
    s0 = _r(rng, b, h, p, n) if with_state else None
    got = tssd.ssd_chunked(_t(x), _t(dtA), _t(B), _t(C), 16,
                           None if s0 is None else _t(s0))
    want = jx.ssd.ssd_chunked(x, dtA, B, C, 16, s0)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_ssd_step_matches_jax(jx):
    rng = np.random.RandomState(6)
    b, h, p, n = 2, 3, 8, 5
    x, dt = _r(rng, b, h, p), rng.uniform(0.01, 0.2, size=(b, h)).astype(np.float32)
    dtA = -dt * 2.0
    B, C, s = _r(rng, b, n), _r(rng, b, n), _r(rng, b, h, p, n)
    got = tssd.ssd_step(_t(x), _t(dtA), _t(dt), _t(B), _t(C), _t(s))
    want = jx.ssd.ssd_step(x, dtA, dt, B, C, s)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_ssd_block_and_step_match_jax(jx):
    """The full Mamba-2 block over 21 tokens (chunk 8: padded), then one
    decode step from its state."""
    rng = np.random.RandomState(7)
    d = 32
    cfg = SSMConfig(d_state=8, head_dim=16, expand=2, chunk=8)
    jcfg = jx.config.SSMConfig(d_state=8, head_dim=16, expand=2, chunk=8)
    di, h, n = cfg.d_inner(d), cfg.n_heads(d), cfg.d_state
    p = {"in_proj": _r(rng, d, 2 * di + 2 * n + h, scale=d ** -0.5),
         "conv_w": _r(rng, 4, di + 2 * n, scale=0.5),
         "dt_bias": np.log(np.expm1(np.linspace(1e-3, 0.1, h))).astype(np.float32),
         "A_log": np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
         "D": np.ones((h,), np.float32), "norm": _r(rng, di, scale=0.1),
         "out_proj": _r(rng, di, d, scale=di ** -0.5)}
    tp = {k: _t(v) for k, v in p.items()}
    x = _r(rng, 2, 21, d)
    y, st = tssd.ssd_block(tp, _t(x), cfg, d)
    yj, stj = jx.ssd.ssd_block(p, x, jcfg, d)
    _close(y, yj)
    _close(st["ssm"], stj["ssm"])
    _close(st["conv"], stj["conv"])
    xs = _r(rng, 2, d)
    y1, st1 = tssd.ssd_block_step(tp, _t(xs), cfg, d, st)
    yj1, stj1 = jx.ssd.ssd_block_step(p, xs, jcfg, d, stj)
    _close(y1, yj1)
    _close(st1["ssm"], stj1["ssm"])
    _close(st1["conv"], stj1["conv"])


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("Hkv", [4, 1])
def test_cross_attention_matches_jax(jx, Hkv):
    rng = np.random.RandomState(8)
    q, k, v = _r(rng, 2, 3, 4, 16), _r(rng, 2, 11, Hkv, 16), _r(rng, 2, 11, Hkv, 16)
    _close(tattn.cross_attention(_t(q), _t(k), _t(v)),
           jx.attn.cross_attention(q, k, v))


def test_non_causal_attention_matches_jax(jx):
    """The whisper encoder's attention: every valid key, no causal mask."""
    rng = np.random.RandomState(9)
    q, k, v = _r(rng, 2, 9, 4, 16), _r(rng, 2, 9, 4, 16), _r(rng, 2, 9, 4, 16)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    _close(tattn.attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), causal=False),
           jx.attn.attention(q, k, v, pos, pos, causal=False))
