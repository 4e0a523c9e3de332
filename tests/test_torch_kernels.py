"""The port's five kernels: decode_attention, paged_decode_attention,
gating_topk, gating_dispatch, grouped_matmul / grouped_mlp.

On the CPU each wrapper takes its plain PyTorch version; those are held
against the JAX package's Pallas kernels run as its own tests run them
(``repro.kernels.ops`` in interpret mode).  Tolerances: values rtol =
atol = 1e-5 in f32 (the same math summed in another order); dispatch
indices exact; counts and gates at 1e-5 (f32 sums).

Cases marked ``cuda`` hold each CUDA kernel against its plain version on
the card; they skip on a machine without one.  bf16 cases there compare
at 2e-2 (one bf16 rounding of the output plus f32 sums in another
order).  The CPU also holds a plain mirror of the decode-attention
kernel's split of the ring and its merge against the plain version, and
plain mirrors of the router kernels' chunked router sum (the cluster
front end gating_dispatch and gating_topk share) against the JAX
package.  The JAX cases get JAX through a fixture that
skips where it is not installed, so the file also collects on the
card's machine.
"""
import os
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch.core import load_balance as lb
from repro_torch.kernels import cuda_build
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import gating_dispatch as gd_mod
from repro_torch.kernels import gating_topk as gt_mod
from repro_torch.kernels import grouped_matmul as gm_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gating_dispatch import gating_dispatch_plain
from repro_torch.kernels.gating_topk import gating_topk_plain
from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
from repro_torch.models.attention import decode_attention as decode_attention_plain
from repro_torch.models.attention import \
    paged_decode_attention as paged_decode_attention_plain
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import softcap

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import load_balance as lb
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return types.SimpleNamespace(jnp=jnp, ops=jops, lb=lb, ref=jref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (it imports nothing
    of the card at import time)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------- decode attention
def _attn_case(b, h, hkv, hd, w, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, hd).astype(np.float32)
    k = rng.randn(b, w, hkv, hd).astype(np.float32)
    v = rng.randn(b, w, hkv, hd).astype(np.float32)
    pos = rng.randint(w // 2, 2 * w, size=b).astype(np.int32)
    # ring slots hold positions pos-w+1..pos; some slots left empty
    cpos = np.stack([(np.arange(w) - p) % w + p - w + 1 for p in pos]).astype(np.int32)
    cpos[:, ::5] = -1
    cpos[0, 1] = pos[0] + 3                           # a slot from the future
    return q, k, v, cpos, pos


ATTN_CASES = [  # (b, h, hkv, hd, w, window, softcap)
    (2, 4, 1, 64, 16, 0, 0.0),      # reduced mixtral shape: rep 4
    (3, 8, 2, 64, 20, 6, 0.0),      # sliding window
    (2, 6, 2, 128, 33, 0, 30.0),    # softcap, ragged W, hd 128
    (2, 10, 1, 256, 40, 16, 0.0),   # recurrentgemma-2b local: hd 256, rep 10
]


@pytest.mark.parametrize("b,h,hkv,hd,w,window,cap", ATTN_CASES)
def test_decode_attention_plain_matches_jax(jx, b, h, hkv, hd, w, window, cap):
    q, k, v, cpos, pos = _attn_case(b, h, hkv, hd, w)
    kw = dict(window=window, attn_softcap=cap)
    got = kops.decode_attention(_t(q), _t(k), _t(v), _t(cpos), _t(pos), **kw)
    a = jx.jnp.asarray
    want = jx.ops.decode_attention(a(q), a(k), a(v), a(cpos), a(pos), **kw)
    _close(got, want)


# the CUDA kernel's split of the ring across blocks and its merge
SPLIT_SHAPES = [  # (B, Hkv, W)
    (4, 8, 256), (8, 8, 256), (8, 8, 64), (1, 1, 1), (2, 2, 33), (1, 8, 4096),
    (64, 8, 256), (1, 1, 8192)]


@pytest.mark.parametrize("B,Hkv,W", SPLIT_SHAPES)
def test_decode_attention_split_plan_covers_the_ring_once(B, Hkv, W):
    """The split count and the scratch shape are functions of the shapes
    alone; the splits' tiles cover the ring's slots exactly once, none
    is empty, and the plan asks for no more blocks than it needs."""
    nsplit, per = da_mod.split_plan(B, Hkv, W)
    tiles = -(-W // da_mod.TILE)
    starts = [s * per * da_mod.TILE for s in range(nsplit)]
    covered = [w for s0 in starts for w in range(s0, min(W, s0 + per * da_mod.TILE))]
    assert covered == list(range(W))
    assert (nsplit - 1) * per < tiles <= nsplit * per
    assert nsplit <= da_mod.MAX_SPLITS
    assert nsplit == 1 or B * Hkv * (nsplit - 1) < da_mod.TARGET_BLOCKS
    assert da_mod.split_plan(B, Hkv, W) == (nsplit, per)
    assert da_mod.scratch_shape(B, 6 * Hkv, Hkv, 128, W) == (B, Hkv, nsplit, 6, 130)


def _split_merge(q, k, v, cpos, pos, window=0, cap=0.0):
    """A plain mirror of the CUDA kernel's rule: per split of the ring
    (``split_plan``), the masked scores' max m, the sum l of exp(s - m)
    over valid slots and the unnormalised accumulator; then the splits
    merged with weights exp(m_s - max m) and the sum clamped at 1e-30."""
    B, H, hd = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    nsplit, per = da_mod.split_plan(B, Hkv, W)
    span = per * da_mod.TILE
    qg = q.float().reshape(B, Hkv, H // Hkv, hd)
    ok = (cpos >= 0) & (cpos <= pos[:, None])
    if window > 0:
        ok = ok & (cpos > pos[:, None] - window)
    parts = []
    for sp in range(nsplit):
        sl = slice(sp * span, min(W, (sp + 1) * span))
        sc = torch.einsum("bgrd,bwgd->bgrw", qg, k[:, sl].float()) * hd ** -0.5
        if cap > 0.0:
            sc = softcap(sc, cap)
        valid = ok[:, None, None, sl]
        sc = torch.where(valid, sc, -1e30)
        m = sc.max(-1).values
        p = torch.exp(sc - m[..., None]) * valid
        parts.append((m, p.sum(-1), torch.einsum("bgrw,bwgd->bgrd", p,
                                                 v[:, sl].float())))
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    acc = sum(torch.exp(m - mx)[..., None] * a for m, _, a in parts)
    den = sum(torch.exp(m - mx) * l for m, l, _ in parts)
    return (acc / den.clamp(min=1e-30)[..., None]).reshape(B, H, hd)


def _prefix_case(b, h, hkv, hd, w, filled, seed=0):
    """A ring filled from slot 0 up to ``filled`` slots (the rest empty),
    every row at the query position filled - 1, as in the serving path's
    early decode steps."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, hd).astype(np.float32)
    k = rng.randn(b, w, hkv, hd).astype(np.float32)
    v = rng.randn(b, w, hkv, hd).astype(np.float32)
    cpos = np.full((b, w), -1, np.int32)
    cpos[:, :filled] = np.arange(filled, dtype=np.int32)
    pos = np.full((b,), filled - 1, np.int32)
    return q, k, v, cpos, pos


@pytest.mark.parametrize("case,window,cap", [
    ((4, 12, 2, 32, 256, 41), 0, 0.0),     # 6 of 8 splits empty
    ((4, 12, 2, 32, 256, 41), 9, 0.0),     # window: the first split empty too
    ((4, 12, 2, 32, 256, 256), 0, 30.0),   # full ring, softcap
    ((3, 8, 2, 64, 20, 20), 6, 0.0),
    ((1, 4, 1, 64, 1, 1), 0, 0.0),         # W = 1
])
def test_split_merge_rule_equals_plain(case, window, cap):
    q, k, v, cpos, pos = map(_t, _prefix_case(*case))
    kw = dict(window=window, attn_softcap=cap)
    want = decode_attention_plain(q, k, v, cpos, pos, **kw)
    _close(_split_merge(q, k, v, cpos, pos, window, cap), want.numpy())


@pytest.mark.parametrize("b,h,hkv,hd,w,window,cap", ATTN_CASES)
def test_split_merge_rule_equals_plain_on_a_wrapped_ring(b, h, hkv, hd, w, window,
                                                        cap):
    q, k, v, cpos, pos = map(_t, _attn_case(b, h, hkv, hd, w))
    kw = dict(window=window, attn_softcap=cap)
    want = decode_attention_plain(q, k, v, cpos, pos, **kw)
    _close(_split_merge(q, k, v, cpos, pos, window, cap), want.numpy())


# ---------------------------------------------------------------- paged decode attention
def _paged_case(b, h, hkv, hd, ps, npg, seed=0):
    """A dense cache scattered into a shuffled page pool, as the JAX
    package's ``test_paged_decode_attention`` builds it: request i owns
    only the pages up to its position; the rest of its table is -1."""
    w = ps * npg
    rng = np.random.RandomState(seed + b * w + h + ps)
    q = rng.randn(b, h, hd).astype(np.float32)
    kc = rng.randn(b, w, hkv, hd).astype(np.float32)
    vc = rng.randn(b, w, hkv, hd).astype(np.float32)
    pos = rng.randint(ps // 2, w, size=(b,)).astype(np.int32)
    cpos = np.broadcast_to(np.arange(w, dtype=np.int32), (b, w))
    cpos = np.where(cpos <= pos[:, None], cpos, -1).astype(np.int32)
    perm = rng.permutation(b * npg)
    bt = np.full((b, npg), -1, np.int32)
    pk = np.zeros((b * npg, ps, hkv, hd), np.float32)
    pv = np.zeros_like(pk)
    ppos = np.full((b * npg, ps), -1, np.int32)
    for i in range(b):
        for lp in range(int(pos[i]) // ps + 1):
            pg = int(perm[i * npg + lp])
            bt[i, lp] = pg
            sl = slice(lp * ps, (lp + 1) * ps)
            pk[pg], pv[pg], ppos[pg] = kc[i, sl], vc[i, sl], cpos[i, sl]
    return (q, pk, pv, ppos, bt, pos), (kc, vc, cpos)


PAGED_CASES = [  # (b, h, hkv, hd, ps, npg, window, softcap): tests/test_kernels.py's
    (2, 4, 2, 16, 8, 4, 0, 0.0),
    (1, 8, 1, 32, 16, 3, 0, 0.0),    # MQA
    (3, 4, 4, 16, 8, 4, 16, 0.0),    # MHA + sliding window
    (2, 4, 2, 32, 8, 4, 0, 50.0),    # softcap
]


@pytest.mark.parametrize("b,h,hkv,hd,ps,npg,window,cap", PAGED_CASES)
def test_paged_decode_attention_plain_matches_jax(jx, b, h, hkv, hd, ps, npg,
                                                  window, cap):
    args, _ = _paged_case(b, h, hkv, hd, ps, npg)
    kw = dict(window=window, attn_softcap=cap)
    got = kops.paged_decode_attention(*map(_t, args), **kw)
    want = jx.ops.paged_decode_attention(*map(jx.jnp.asarray, args), **kw)
    _close(got, want)


def test_paged_decode_attention_refuses_a_page_outside_the_pool():
    args, _ = _paged_case(2, 4, 2, 16, 8, 4)
    q, pk, pv, ppos, bt, pos = map(_t, args)
    bt[0, 0] = pk.shape[0]
    with pytest.raises(ValueError, match="pool size"):
        kops.paged_decode_attention(q, pk, pv, ppos, bt, pos)


def _gathered(pk, pv, ppos, bt):
    """The dense (B, n_logical * ps) view of a pool, as ``PagePool.gather``
    builds it: unmapped logical pages read page 0 with pos -1."""
    B, n = bt.shape
    W = n * pk.shape[1]
    btc = bt.long().clamp(min=0)
    k = pk[btc].reshape((B, W) + tuple(pk.shape[2:]))
    v = pv[btc].reshape((B, W) + tuple(pv.shape[2:]))
    cpos = torch.where((bt >= 0)[:, :, None], ppos[btc], -1).reshape(B, W)
    return k, v, cpos


@pytest.mark.parametrize("ps", [4, 8, 32, 64])
def test_paged_split_plan_equals_decode_attention_plan_on_the_gathered_view(ps):
    """The paged kernel splits its n_logical * ps logical slots as the
    ring kernel splits a ring of that width (so over one pool the two
    kernels run the same arithmetic), and that split rule over the
    gathered view equals the plain paged version."""
    npg = 128 // ps
    args, _ = _paged_case(2, 8, 2, 32, ps, npg)
    q, pk, pv, ppos, bt, pos = map(_t, args)
    assert da_mod.split_plan(2, 2, npg * ps)[0] > 1
    for window, cap in ((0, 0.0), (40, 0.0), (0, 30.0)):
        want = paged_decode_attention_plain(q, pk, pv, ppos, bt, pos, window=window,
                                            attn_softcap=cap)
        k, v, cpos = _gathered(pk, pv, ppos, bt)
        _close(_split_merge(q, k, v, cpos, pos, window, cap), want.numpy())


# ---------------------------------------------------------------- gating top-k
def _topk_equal(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1].dtype == got[2].dtype == torch.int32
    _close(got[0], want[0])


@pytest.mark.parametrize("t,d,e,k", [(8, 16, 4, 2), (96, 48, 16, 4), (4, 64, 8, 2),
                                     (33, 20, 8, 8)])
def test_gating_topk_plain_matches_jax(jx, t, d, e, k):
    x, w = _dispatch_case(t, d, e)
    got = kops.gating_topk(_t(x), _t(w), k)
    _topk_equal(got, jx.ref.gating_topk_ref(jx.jnp.asarray(x), jx.jnp.asarray(w), k))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_gating_topk_ties_take_lowest_index(jx, k):
    x, w = _tie_case()
    got = kops.gating_topk(_t(x), _t(w), k)
    _topk_equal(got, jx.ref.gating_topk_ref(jx.jnp.asarray(x), jx.jnp.asarray(w), k))


def test_topk_with_underflowing_probabilities_follows_lax_top_k(jx):
    """Router logits [200, 0, ..., 0]: in f32 every probability but the
    first underflows to 0.  ``jax.lax.top_k`` (the oracle
    ``ref.gating_topk_ref``) then picks experts [0, 1].  The port's
    gating_topk and gating_dispatch follow it.  The JAX TPU kernels do
    not: ``_topk_core`` masks a chosen expert by multiplying it to 0, so
    ``repro.kernels.ops.gating_topk`` returns experts [[0, 0], [3, 0]]
    with counts [3, 0, 0, 1, 0, 0, 0, 0] on this input (its
    gating_dispatch shares the core)."""
    e, k = 8, 2
    x = np.zeros((2, e), np.float32)
    x[0, 0] = 200.0
    x[1, 3] = 200.0
    w = np.eye(e, dtype=np.float32)
    want = jx.ref.gating_topk_ref(jx.jnp.asarray(x), jx.jnp.asarray(w), k)
    assert np.asarray(want[1]).tolist() == [[0, 1], [3, 0]]
    _topk_equal(kops.gating_topk(_t(x), _t(w), k), want)
    idx_buf, gate_buf, counts = gating_dispatch_plain(_t(x), _t(w), k, e, 2)
    chosen = sorted((int(ex), int(tok)) for ex in range(e) for tok in idx_buf[ex]
                    if tok < 2)
    assert chosen == [(0, 0), (0, 1), (1, 0), (3, 1)]
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2], np.float32))


# ---------------------------------------------------------------- gating dispatch
def _dispatch_case(t, d, e, seed=0):
    rng = np.random.RandomState(seed + t + e)
    return (rng.randn(t, d).astype(np.float32), rng.randn(d, e).astype(np.float32))


def _assert_dispatch_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])
    _close(got[2], want[2])


def _both(jx, x, w, k, n_buckets, capacity, **kw):
    a = jx.jnp.asarray
    tk = {key: (_t(v) if isinstance(v, np.ndarray) else v) for key, v in kw.items()}
    jk = {key: (a(v) if isinstance(v, np.ndarray) else v) for key, v in kw.items()}
    got = kops.gating_dispatch(_t(x), _t(w), k, n_buckets, capacity, **tk)
    want = jx.ops.gating_dispatch(a(x), a(w), k, n_buckets=n_buckets,
                                  capacity=capacity, **jk)
    return got, want


@pytest.mark.parametrize("t,d,e,k", [(8, 16, 4, 2), (96, 48, 16, 4), (4, 64, 8, 2)])
def test_gating_dispatch_full_matches_jax(jx, t, d, e, k):
    x, w = _dispatch_case(t, d, e)
    _assert_dispatch_equal(*_both(jx, x, w, k, e, t))


def test_gating_dispatch_capped_drops_match_jax(jx):
    t, d, e, k, cap = 128, 32, 4, 2, 8
    x, w = _dispatch_case(t, d, e, seed=7)
    got, want = _both(jx, x, w, k, e, cap)
    _assert_dispatch_equal(got, want)
    assert int((got[0] < t).sum()) == e * cap          # every bucket full


def test_gating_dispatch_bias_and_weights_match_jax(jx):
    t, d, e, k = 64, 32, 8, 2
    x, w = _dispatch_case(t, d, e, seed=3)
    bias = np.linspace(-1.0, 1.0, e).astype(np.float32)
    cw = (np.arange(t) % 2).astype(np.float32)
    got, want = _both(jx, x, w, k, e, t, bias=bias, count_weights=cw)
    _assert_dispatch_equal(got, want)
    assert float(got[2].sum()) == pytest.approx(float(cw.sum()) * k)


@pytest.mark.parametrize("owner", [0, 1, 3])
def test_gating_dispatch_owner_filter_matches_jax(jx, owner):
    t, d, e, k, shards = 64, 32, 8, 2, 4
    x, w = _dispatch_case(t, d, e, seed=11)
    got, want = _both(jx, x, w, k, e, 16, owner=owner, slots_per_node=e // shards)
    _assert_dispatch_equal(got, want)
    assert tuple(got[0].shape) == (e // shards, 16)


@pytest.mark.parametrize("owner", [None, 0, 2])
def test_gating_dispatch_placement_tables_match_jax(jx, owner):
    t, d, e, k, nodes, S = 96, 32, 8, 2, 4, 4
    x, w = _dispatch_case(t, d, e, seed=5)
    tbl = jx.lb.placement_tables(
        jx.lb.balance_experts([100.0] + [4.0] * (e - 1), nodes), S)
    assert tbl.rep_node.shape[1] > 1
    kw = dict(slots_per_node=S, rep_node=tbl.rep_node.astype(np.int32),
              rep_slot=tbl.rep_slot.astype(np.int32),
              rep_cum=tbl.rep_cum.astype(np.float32))
    if owner is not None:
        kw["owner"] = owner
    _assert_dispatch_equal(*_both(jx, x, w, k, nodes * S, 12, **kw))


def _tie_case():
    """Integer-valued inputs, so every logit is exact whatever the sum
    order: experts 1 and 3 tie for first, 2 and 5 for third."""
    rng = np.random.RandomState(9)
    t, d, e = 12, 8, 6
    x = rng.randint(0, 3, size=(t, d)).astype(np.float32)
    w = rng.randint(-2, 1, size=(d, e)).astype(np.float32)
    w[:, 1] = w[:, 3] = 2.0
    w[:, 2] = w[:, 5] = 1.0
    return x, w


@pytest.mark.parametrize("k", [1, 2, 3])
def test_gating_dispatch_ties_take_lowest_index(jx, k):
    x, w = _tie_case()
    got, want = _both(jx, x, w, k, w.shape[1], x.shape[0])
    _assert_dispatch_equal(got, want)
    used = set(np.nonzero((got[0] < x.shape[0]).numpy().any(1))[0].tolist())
    assert used == {1: {1}, 2: {1, 3}, 3: {1, 2, 3}}[k]


@pytest.mark.parametrize("d", [16, 48, 6000, 6144, 16384])
def test_gating_dispatch_chunk_plan_covers_d_once(d):
    """The cluster's blocks sum chunks of d that cover it exactly once,
    in order, each starting on a multiple of 8 rows (16-byte rows of x
    and of the router)."""
    plan = gd_mod.chunk_plan(d)
    assert len(plan) == gd_mod.CLUSTER
    assert [i for a, b in plan for i in range(a, b)] == list(range(d))
    assert all(a % gd_mod.CHUNK_ALIGN == 0 for a, b in plan if b > a)
    per = gd_mod.chunk_rows(d)
    assert per % gd_mod.CHUNK_ALIGN == 0 and per * gd_mod.CLUSTER >= d
    assert (per - gd_mod.CHUNK_ALIGN) * gd_mod.CLUSTER < d     # the least such


def _chunked_dispatch(x, w, k, n_buckets, capacity, bias=None, count_weights=None):
    """A plain mirror of the CUDA kernel's router sum: each block's
    partial logits x[:, chunk] @ w[chunk] over ``chunk_plan``, added in
    chunk order, then the bias; then the softmax, top-k, counts and slot
    build of the plain version."""
    parts = [x[:, a:b].float() @ w[a:b].float() for a, b in gd_mod.chunk_plan(x.shape[1])]
    logits = parts[0]
    for part in parts[1:]:
        logits = logits + part
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = moe_lib.topk_lowest_index(probs, k)
    routing = moe_lib.Routing(gates / gates.sum(-1, keepdim=True),
                              experts.to(torch.int32), probs)
    counts = moe_lib.routing_counts(routing, w.shape[1], count_weights)
    return (*moe_lib.dispatch_indices(routing, n_buckets, capacity), counts)


def _dispatch_cases():
    """The cases of the gating_dispatch tests above: (x, w, k, capacity,
    keyword arguments)."""
    out = []
    for t, d, e, k in ((8, 16, 4, 2), (96, 48, 16, 4), (4, 64, 8, 2)):
        out.append(("full", *_dispatch_case(t, d, e), k, t, {}))
    out.append(("capped", *_dispatch_case(128, 32, 4, seed=7), 2, 8, {}))
    x, w = _dispatch_case(64, 32, 8, seed=3)
    out.append(("bias", x, w, 2, 64,
                dict(bias=np.linspace(-1.0, 1.0, 8).astype(np.float32),
                     count_weights=(np.arange(64) % 2).astype(np.float32))))
    for k in (1, 2, 3):
        out.append(("ties", *_tie_case(), k, 12, {}))
    return out


@pytest.mark.parametrize("case", range(8))
def test_gating_dispatch_chunked_router_sum_matches_jax(jx, case):
    name, x, w, k, cap, kw = _dispatch_cases()[case]
    e = w.shape[1]
    got = _chunked_dispatch(_t(x), _t(w), k, e, cap, **{a: _t(v) for a, v in kw.items()})
    a = jx.jnp.asarray
    want = jx.ops.gating_dispatch(a(x), a(w), k, n_buckets=e, capacity=cap,
                                  **{n: a(v) for n, v in kw.items()})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[1], want[1])


def test_gating_dispatch_launches_by_token_count():
    assert [gd_mod.dispatch_launches(t) for t in (1, 4, 16, 17, 128)] == [1, 1, 1, 2, 2]


def _chunked_topk(x, w, k):
    """A plain mirror of the gating_topk kernel's arithmetic (the cluster
    front end it shares with gating_dispatch): the partial logits
    x[:, a:b] @ w[a:b] over ``chunk_plan`` added in chunk order, then the
    softmax, ``topk_lowest_index`` and the counts."""
    parts = [x[:, a:b].float() @ w[a:b].float() for a, b in gd_mod.chunk_plan(x.shape[1])]
    logits = parts[0]
    for part in parts[1:]:
        logits = logits + part
    probs = torch.softmax(logits, dim=-1)
    gates, experts = moe_lib.topk_lowest_index(probs, k)
    routing = moe_lib.Routing(gates / gates.sum(-1, keepdim=True),
                              experts.to(torch.int32), probs)
    counts = moe_lib.routing_counts(routing, w.shape[1])
    return routing.gates, routing.experts, counts.to(torch.int32)


@pytest.mark.parametrize("case", range(8))
def test_gating_topk_chunked_router_sum_matches_jax(jx, case):
    """``_chunked_topk`` against the JAX package's Pallas gating_topk run in
    interpret mode, on the dispatch cases' x, router and k (none of them
    underflows, where the TPU kernel repeats expert 0): experts and counts
    exact, gates within 1e-5."""
    name, x, w, k, _, _ = _dispatch_cases()[case]
    got = _chunked_topk(_t(x), _t(w), k)
    want = jx.ops.gating_topk(jx.jnp.asarray(x), jx.jnp.asarray(w), k)
    _topk_equal(got, want)


def test_gating_topk_launches_by_token_count():
    assert [gt_mod.topk_launches(t) for t in (1, 4, 16, 17, 128)] == [1, 1, 1, 2, 2]


# ---------------------------------------------------------------- grouped matmul
@pytest.mark.parametrize("g,m,k,n", [(1, 8, 16, 8), (4, 32, 64, 16), (2, 100, 60, 28),
                                     (8, 4, 96, 80)])
def test_grouped_matmul_plain_matches_jax(jx, g, m, k, n):
    rng = np.random.RandomState(g * m + n)
    x = rng.randn(g, m, k).astype(np.float32)
    w = rng.randn(g, k, n).astype(np.float32)
    got = kops.grouped_matmul(_t(x), _t(w))
    want = jx.ops.grouped_matmul(jx.jnp.asarray(x), jx.jnp.asarray(w))
    _close(got, want, dict(rtol=1e-5, atol=1e-4))   # |out| ~ sqrt(k)


@pytest.mark.parametrize("use_valid", [False, True])
def test_grouped_mlp_plain_matches_jax(jx, use_valid):
    rng = np.random.RandomState(1)
    E, C, d, f = 4, 8, 32, 48
    xe = rng.randn(E, C, d).astype(np.float32) * 0.5
    ws = [rng.randn(*s).astype(np.float32) * 0.2
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    kw = {}
    if use_valid:
        kw["row_valid"] = rng.rand(E, C) > 0.3
    got = kops.grouped_mlp(_t(xe), *map(_t, ws), "silu",
                           **{k: _t(v) for k, v in kw.items()})
    a = jx.jnp.asarray
    want = jx.ops.grouped_mlp(a(xe), *map(a, ws), "silu",
                              **{k: a(v) for k, v in kw.items()})
    _close(got, want)
    if use_valid:
        assert not got[~_t(kw["row_valid"])].any()


def _table(E, C, T, counts, gap=False):
    """An (E, C) dispatch table (sentinel T): expert e holds counts[e]
    tokens in its first slots; ``gap`` empties the middle one of each."""
    idx = np.full((E, C), T, dtype=np.int32)
    rng = np.random.RandomState(E * C)
    for e, c in enumerate(counts):
        idx[e, :c] = rng.permutation(T)[:c]
        if gap and c > 2:
            idx[e, c // 2] = T
    return torch.from_numpy(idx)


# (C, per-expert counts, gap): one empty expert in each; a full expert
TABLES = [(16, (3, 0, 16, 7), False), (16, (5, 0, 1, 9), True),
          (64, (17, 0, 64, 40), False), (64, (30, 0, 2, 63), True)]


@pytest.mark.parametrize("C,counts,gap", TABLES)
def test_grouped_matmul_plain_live_rows(C, counts, gap):
    """With the dispatch table, the plain version is the full product
    with each expert's rows at and past its live count (1 + its last
    slot that is not the sentinel) set to exact zeros; an expert with no
    live row is all zeros, and a gap below the last live slot is
    computed like any row."""
    E, K, N, T = len(counts), 24, 40, 70
    rng = np.random.RandomState(C)
    x = _t(rng.randn(E, C, K).astype(np.float32))
    w = _t(rng.randn(E, K, N).astype(np.float32))
    idx = _table(E, C, T, counts, gap)
    got = kops.grouped_matmul(x, w, idx=idx, n_tokens=T)
    full = kops.grouped_matmul(x, w)
    live = gm_mod.live_rows(idx, T)
    assert live.tolist() == list(counts)     # a gap leaves the last slot live
    for e, n in enumerate(counts):
        assert torch.equal(got[e, :n], full[e, :n])
        assert not got[e, n:].any()
    assert not got[1].any()


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("C,counts,gap", TABLES[:2])
def test_grouped_mlp_live_rows(act, C, counts, gap):
    """``grouped_mlp`` with the table forwards it to its three launches:
    the MLP of the live rows, exact zeros past them."""
    E, d, f, T = len(counts), 32, 48, 70
    rng = np.random.RandomState(2)
    xe = _t(rng.randn(E, C, d).astype(np.float32) * 0.5)
    ws = [_t(rng.randn(*s).astype(np.float32) * 0.2)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    idx = _table(E, C, T, counts, gap)
    got = kops.grouped_mlp(xe, *ws, act, idx=idx, n_tokens=T)
    full = kops.grouped_mlp(xe, *ws, act)
    for e, n in enumerate(counts):
        assert torch.equal(got[e, :n], full[e, :n])
        assert not got[e, n:].any()


# ---------------------------------------------------------------- build layer
def test_library_name_tracks_the_source():
    """An edited source gets a new library name, so a stale build is
    never loaded."""
    p = cuda_build.library_path("grouped_matmul.cu")
    assert p.parent == cuda_build.BUILD_DIR and p.suffix == ".so"
    assert p != cuda_build.library_path("decode_attention.cu")
    assert set(cuda_build.REGISTRY) == {
        "decode_attention.cu", "paged_decode_attention.cu", "gating_topk.cu",
        "gating_dispatch.cu", "grouped_matmul.cu"}


def test_build_without_nvcc_raises():
    if shutil.which("nvcc"):
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["grouped_matmul.cu"])


def test_plain_route_counts_no_launch():
    cuda_build.reset_launch_counts()
    x = torch.randn(2, 3, 8)
    kops.grouped_mlp(x, torch.randn(2, 8, 4), torch.randn(2, 8, 4),
                     torch.randn(2, 4, 8))
    assert set(cuda_build.launch_counts().values()) == {0}


@pytest.mark.parametrize("b,h,hkv,hd,w,window,cap", ATTN_CASES)
def test_decode_attention_partial_on_cpu_is_the_plain_partial(b, h, hkv, hd, w,
                                                              window, cap):
    """The wrapper's partial branch on CPU tensors: the plain version's
    (out f32, lse), out equal to the whole row where the slots given are
    the whole ring."""
    from repro_torch.models.attention import decode_attention_partial
    args = [_t(a) for a in _attn_case(b, h, hkv, hd, w)]
    kw = dict(window=window, attn_softcap=cap)
    out, lse = kops.decode_attention(*args, partial=True, **kw)
    want_out, want_lse = decode_attention_partial(*args, **kw)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (b, h)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    _close(out, decode_attention_plain(*args, **kw).numpy())


def _wrapped_ring_block(b, h, hd, W, n, i, seed=0):
    """Block i of n of a W-slot ring with one kv head that every row has
    wrapped (recurrentgemma-2b's local layer on n model ranks): q (b, h,
    hd), the whole ring's k / v (b, W, 1, hd) and positions, pos (b,), and
    the block's slice of the slots.  Slot s holds the row's latest
    position congruent to s mod W."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, hd).astype(np.float32)
    k = rng.randn(b, W, 1, hd).astype(np.float32)
    v = rng.randn(b, W, 1, hd).astype(np.float32)
    pos = rng.randint(W, 3 * W, size=b).astype(np.int32)
    cpos = np.stack([p - (p - np.arange(W)) % W for p in pos]).astype(np.int32)
    wl = W // n
    return q, k, v, cpos, pos, slice(i * wl, (i + 1) * wl)


def test_decode_attention_partial_on_a_wrapped_ring_block_on_cpu():
    """The partial branch at recurrentgemma's local shape on a rank's
    block (rep 10, one kv head, hd 256, a 2048-slot ring in 4 blocks of
    512, window 2048) on CPU tensors: the plain version's, and the 4
    blocks merged by ``merge_partials`` equal the whole ring's row."""
    from repro_torch.models.attention import decode_attention_partial
    from repro_torch.models.parallel import ModelParallel
    from test_torch_model_axis_decode import _Stacked
    outs, lses = [], []
    for i in range(4):
        q, k, v, cpos, pos, sl = _wrapped_ring_block(2, 10, 256, 2048, 4, i)
        args = [_t(q), _t(k[:, sl]), _t(v[:, sl]), _t(cpos[:, sl]), _t(pos)]
        out, lse = kops.decode_attention(*args, partial=True, window=2048)
        want_out, want_lse = decode_attention_partial(*args, window=2048)
        assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
        outs.append(out)
        lses.append(lse)
    whole = decode_attention_plain(_t(q), _t(k), _t(v), _t(cpos), _t(pos),
                                   window=2048)
    merged = ModelParallel(_Stacked(4)).merge_partials(torch.stack(outs),
                                                       torch.stack(lses))
    for i in range(4):
        _close(merged[i], whole.numpy())


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [0, 1, 3])
def test_decode_attention_partial_kernel_on_a_wrapped_ring_block(cuda, dtype, block):
    """The partial branch at recurrentgemma-2b's local shape on one of 4
    ranks (q (8, 10, 256) over a (8, 512, 1, 256) block of a wrapped
    2048-slot ring) against its plain version: f32 1e-5, bf16 2e-2; a
    row whose block holds no valid slot gives 0 and -inf."""
    from repro_torch.models.attention import decode_attention_partial
    q, k, v, cpos, pos, sl = _wrapped_ring_block(8, 10, 256, 2048, 4, block)
    cpos = np.ascontiguousarray(cpos[:, sl])
    cpos[0] = -1                                  # row 0: no valid slot
    args = [_t(a).to(cuda).to(dtype) for a in (q, np.ascontiguousarray(k[:, sl]),
                                               np.ascontiguousarray(v[:, sl]))]
    args += [_t(cpos).to(cuda), _t(pos).to(cuda)]
    n0 = da_mod.KERNEL.variant_launches["partial"]
    out, lse = kops.decode_attention(*args, partial=True, window=2048)
    torch.cuda.synchronize()
    assert da_mod.KERNEL.variant_launches["partial"] == n0 + 1
    want_out, want_lse = decode_attention_partial(*args, window=2048)
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    assert torch.isneginf(lse[0]).all() and float(out[0].abs().max()) == 0
    _close(out, want_out.cpu().numpy(), tol)
    _close(lse[1:], want_lse[1:].cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,hd,w,window,cap", ATTN_CASES
                         + [(8, 24, 8, 128, 64, 0, 0.0)])
def test_decode_attention_partial_kernel_matches_plain(cuda, dtype, b, h, hkv, hd,
                                                       w, window, cap):
    """The partial branch (a rank's block of slots) against its plain
    version: out and lse f32, a block with no valid slot 0 and -inf."""
    from repro_torch.models.attention import decode_attention_partial
    q, k, v, cpos, pos = _attn_case(b, h, hkv, hd, w)
    cpos[0] = -1                                  # row 0: no valid slot
    args = [_t(a).to(cuda).to(dtype) for a in (q, k, v)]
    args += [_t(cpos).to(cuda), _t(pos).to(cuda)]
    kw = dict(window=window, attn_softcap=cap)
    n0 = da_mod.KERNEL.variant_launches["partial"]
    out, lse = kops.decode_attention(*args, partial=True, **kw)
    torch.cuda.synchronize()
    assert da_mod.KERNEL.variant_launches["partial"] == n0 + 1
    want_out, want_lse = decode_attention_partial(*args, **kw)
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    assert torch.isneginf(lse[0]).all() and float(out[0].abs().max()) == 0
    _close(out, want_out.cpu().numpy(), tol)
    _close(lse[1:], want_lse[1:].cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,hd,w,window,cap", ATTN_CASES
                         + [(4, 48, 8, 128, 200, 0, 0.0)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, b, h, hkv, hd, w,
                                               window, cap):
    q, k, v, cpos, pos = _attn_case(b, h, hkv, hd, w)
    args = [_t(a).to(cuda) for a in (q, k, v)]
    args = [a.to(dtype) for a in args] + [_t(cpos).to(cuda), _t(pos).to(cuda)]
    kw = dict(window=window, attn_softcap=cap)
    n0 = da_mod.KERNEL.launches
    got = kops.decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert da_mod.KERNEL.launches == n0 + 1
    want = decode_attention_plain(*args, **kw)
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    _close(got, want.float().cpu().numpy(), tol)


def _on_card(cuda, dtype, q, k, v, cpos, pos):
    return ([_t(a).to(cuda).to(dtype) for a in (q, k, v)]
            + [_t(cpos).to(cuda), _t(pos).to(cuda)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (4, 48, 8, 128, 256, 256),    # full ring, B = 4 (8 splits of one tile)
    (8, 48, 8, 128, 256, 256),    # full ring, B = 8
    (4, 48, 8, 128, 256, 41),     # the serving path's early step: 6 empty splits
    (2, 8, 2, 64, 1, 1),          # W = 1
])
def test_decode_attention_kernel_split_shapes(cuda, dtype, case):
    args = _on_card(cuda, dtype, *_prefix_case(*case))
    got = kops.decode_attention(*args)
    again = kops.decode_attention(*args)
    want = decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)          # fixed split count and merge order
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    _close(got, want.float().cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_only_slot_in_the_last_split(cuda, dtype):
    """Row 1's only valid slot is the ring's last one, in the last split;
    every other split of that row is empty and must weigh nothing."""
    q, k, v, cpos, pos = _prefix_case(4, 48, 8, 128, 256, 41)
    cpos[1] = -1
    cpos[1, -1] = 7
    pos[1] = 7
    assert da_mod.split_plan(4, 8, 256)[0] > 1
    args = _on_card(cuda, dtype, q, k, v, cpos, pos)
    got = kops.decode_attention(*args)
    want = decode_attention_plain(*args)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    _close(got, want.float().cpu().numpy(), tol)
    # one valid slot: the output is that slot's V row, repeated per head
    _close(got[1].reshape(8, 6, 128)[:, 0], args[2][1, -1].float().cpu().numpy(),
           tol)


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_a_misaligned_view(cuda):
    q, k, v, cpos, pos = _on_card(cuda, torch.bfloat16,
                                  *_prefix_case(2, 8, 2, 64, 32, 32))
    base = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    qm = base[1:].view(q.shape)
    qm.copy_(q)
    assert qm.is_contiguous() and qm.storage_offset() == 1
    with pytest.raises(ValueError, match="16-byte"):
        kops.decode_attention(qm, k, v, cpos, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,hd,ps,npg,window,cap", [
    (2, 8, 2, 64, 8, 4, 0, 0.0), (1, 8, 1, 128, 16, 3, 0, 0.0),
    (3, 4, 4, 64, 8, 4, 16, 0.0), (2, 8, 2, 128, 8, 4, 0, 50.0),
    (4, 48, 8, 128, 8, 32, 0, 0.0), (3, 16, 1, 64, 64, 2, 0, 0.0),
    (2, 10, 1, 256, 8, 6, 20, 0.0)])
def test_paged_decode_attention_kernel_matches_plain(cuda, dtype, b, h, hkv, hd,
                                                     ps, npg, window, cap):
    args, dense = _paged_case(b, h, hkv, hd, ps, npg)
    q, pk, pv, ppos, bt, pos = [_t(a).to(cuda) for a in args]
    q, pk, pv = q.to(dtype), pk.to(dtype), pv.to(dtype)
    kw = dict(window=window, attn_softcap=cap)
    n0 = da_mod.PAGED_KERNEL.launches
    got = kops.paged_decode_attention(q, pk, pv, ppos, bt, pos, **kw)
    torch.cuda.synchronize()
    assert da_mod.PAGED_KERNEL.launches == n0 + 1
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    want = paged_decode_attention_plain(q, pk, pv, ppos, bt, pos, **kw)
    _close(got, want.float().cpu().numpy(), tol)
    kc, vc, cpos = [_t(a).to(cuda) for a in dense]
    dense_out = kops.decode_attention(q, kc.to(dtype), vc.to(dtype), cpos, pos, **kw)
    assert torch.equal(got, dense_out)      # one split plan, one kernel body


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [4, 8, 32, 64])
@pytest.mark.parametrize("kw", [{}, dict(window=40), dict(attn_softcap=30.0)])
def test_paged_decode_attention_kernel_equals_decode_attention_on_the_gathered_view(
        cuda, dtype, ps, kw):
    """At the serving shape (48 / 8 heads, hd 128, 256 logical slots) and
    pages smaller than, equal to and larger than a 32-slot tile, the
    paged kernel is bit-identical to decode_attention over the pool's
    gathered view, and within tolerance of its plain version."""
    args, _ = _paged_case(4, 48, 8, 128, ps, 256 // ps)
    q, pk, pv, ppos, bt, pos = [_t(a).to(cuda) for a in args]
    q, pk, pv = q.to(dtype), pk.to(dtype), pv.to(dtype)
    n0 = da_mod.PAGED_KERNEL.launches
    got = kops.paged_decode_attention(q, pk, pv, ppos, bt, pos, **kw)
    again = kops.paged_decode_attention(q, pk, pv, ppos, bt, pos, **kw)
    k, v, cpos = _gathered(pk, pv, ppos, bt)
    dense = kops.decode_attention(q, k, v, cpos, pos, **kw)
    want = paged_decode_attention_plain(q, pk, pv, ppos, bt, pos, **kw)
    torch.cuda.synchronize()
    assert da_mod.PAGED_KERNEL.launches == n0 + 2
    assert torch.equal(got, dense) and torch.equal(got, again)
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    _close(got, want.float().cpu().numpy(), tol)


# the registry's routers (d, E, top-k): mixtral-8x22b, qwen2-moe-a2.7b,
# arctic-480b
ROUTERS = [(6144, 8, 2), (2048, 60, 4), (7168, 128, 2)]


def _router_case(t, d, e, seed=0):
    """x (t, d) and a router at its init scale (d ** -0.5), so the logits
    are O(1) as a model's are."""
    x, w = _dispatch_case(t, d, e, seed)
    return x, (w / np.sqrt(d)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,e,k,router", [
    (8, 16, 4, 2, False), (4, 6144, 8, 2, False), (96, 48, 16, 4, False),
    (33, 20, 8, 8, False)] + [(t, d, e, k, True) for d, e, k in ROUTERS
                              for t in (1, 4, 8, 16, 17, 128)])
def test_gating_topk_kernel_matches_plain(cuda, dtype, t, d, e, k, router):
    """One launch counted per call (one or two device ops: the counts take
    a second launch past 16 tokens), experts and counts equal to plain,
    gates within 1e-5, two calls bit-identical."""
    x, w = (_router_case if router else _dispatch_case)(t, d, e)
    xt, wt = _t(x).to(cuda, dtype), _t(w).to(cuda)
    n0 = gt_mod.KERNEL.launches
    got = kops.gating_topk(xt, wt, k)
    again = kops.gating_topk(xt, wt, k)
    want = gating_topk_plain(xt, wt, k)
    torch.cuda.synchronize()
    assert gt_mod.KERNEL.launches == n0 + 2
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(got[0], want[0].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,e,k", ROUTERS)
@pytest.mark.parametrize("t", [1, 4, 16, 17, 128])
def test_gating_topk_kernel_is_gating_dispatchs_front_end(cuda, dtype, d, e, k, t):
    """gating_dispatch with E buckets, capacity T and no bias drops
    nothing: its buffers hold exactly gating_topk's (token, expert) pairs,
    with its gates bit for bit (one front end, one sum order)."""
    x, w = _router_case(t, d, e, seed=1)
    xt, wt = _t(x).to(cuda, dtype), _t(w).to(cuda)
    gates, experts, _ = (a.cpu() for a in kops.gating_topk(xt, wt, k))
    idx, gbuf, _ = (a.cpu() for a in kops.gating_dispatch(xt, wt, k, e, t))
    want = sorted((int(ex), tok, float(g)) for tok in range(t)
                  for ex, g in zip(experts[tok].tolist(), gates[tok].tolist()))
    got = sorted((ex, int(idx[ex, c]), float(gbuf[ex, c])) for ex in range(e)
                 for c in range(t) if int(idx[ex, c]) < t)
    assert got == want


@pytest.mark.cuda
def test_gating_topk_kernel_refuses_a_misaligned_view(cuda):
    x, w = _dispatch_case(4, 64, 8)
    xt = _t(x).to(cuda, torch.bfloat16)
    base = torch.empty(xt.numel() + 1, dtype=xt.dtype, device=cuda)
    xm = base[1:].view(xt.shape)
    xm.copy_(xt)
    n0 = gt_mod.KERNEL.launches
    with pytest.raises(ValueError, match="16-byte"):
        kops.gating_topk(xm, _t(w).to(cuda), 2)
    assert gt_mod.KERNEL.launches == n0


@pytest.mark.cuda
def test_gating_topk_kernel_follows_lax_top_k_on_underflow(cuda):
    x = torch.zeros(2, 8, device=cuda)
    x[0, 0], x[1, 3] = 200.0, 200.0
    gates, experts, counts = kops.gating_topk(x, torch.eye(8, device=cuda), 2)
    assert experts.tolist() == [[0, 1], [3, 0]]
    assert counts.tolist() == [2, 1, 0, 1, 0, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,e,k,cap", [(8, 16, 4, 2, 8), (4, 6144, 8, 2, 4),
                                         (128, 32, 4, 2, 8), (64, 64, 16, 4, 64)])
def test_gating_dispatch_kernel_matches_plain(cuda, dtype, t, d, e, k, cap):
    x, w = _dispatch_case(t, d, e)
    xt, wt = _t(x).to(cuda, dtype), _t(w).to(cuda)
    cw = (torch.arange(t, device=cuda) % 3 > 0).float()
    bias = torch.linspace(-0.5, 0.5, e, device=cuda)
    got = kops.gating_dispatch(xt, wt, k, e, cap, bias=bias, count_weights=cw)
    want = gating_dispatch_plain(xt, wt, k, e, cap, bias=bias, count_weights=cw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    _close(got[1], want[1].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 8, 16, 17, 128])
@pytest.mark.parametrize("e", [4, 8, 16, 256])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_gating_dispatch_kernel_token_and_expert_counts(cuda, t, e, k):
    """One launch (t <= 16) and two (t > 16), with a bias, 0/1 count
    weights and a capacity below the mean load (drops where the routing
    allows them); two calls on the same inputs are bit-identical."""
    x, w = _dispatch_case(t, 96, e, seed=k)
    xt, wt = _t(x).to(cuda, torch.bfloat16), _t(w).to(cuda)
    cap = max(1, t * k // e)
    kw = dict(bias=torch.linspace(-0.5, 0.5, e, device=cuda),
              count_weights=(torch.arange(t, device=cuda) % 3 > 0).float())
    n0 = gd_mod.KERNEL.launches
    got = kops.gating_dispatch(xt, wt, k, e, cap, **kw)
    again = kops.gating_dispatch(xt, wt, k, e, cap, **kw)
    want = gating_dispatch_plain(xt, wt, k, e, cap, **kw)
    torch.cuda.synchronize()
    assert gd_mod.KERNEL.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    _close(got[1], want[1].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(4, 37), (20, 37), (3, 6144), (16, 16384)])
def test_gating_dispatch_kernel_widths(cuda, dtype, t, d):
    """d not a multiple of 8 (rows of x copied element by element) and
    chunks larger than one shared-memory tile; no bias, no weights."""
    x, w = _dispatch_case(t, d, 8)
    xt, wt = _t(x).to(cuda, dtype), _t((w / np.sqrt(d)).astype(np.float32)).to(cuda)
    got = kops.gating_dispatch(xt, wt, 2, 8, t)
    want = gating_dispatch_plain(xt, wt, 2, 8, t)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    _close(got[1], want[1].cpu().numpy())


@pytest.mark.cuda
def test_gating_dispatch_kernel_refuses_a_misaligned_view(cuda):
    x, w = _dispatch_case(4, 64, 8)
    xt = _t(x).to(cuda, torch.bfloat16)
    base = torch.empty(xt.numel() + 1, dtype=xt.dtype, device=cuda)
    xm = base[1:].view(xt.shape)
    xm.copy_(xt)
    with pytest.raises(ValueError, match="16-byte"):
        kops.gating_dispatch(xm, _t(w).to(cuda), 2, 8, 4)


def _branch_kwargs(cuda, case, e, owner=None):
    """gating_dispatch keyword arguments of one branch case: "tables"
    (4 nodes x 4 slots, hot expert 0 replicated), "owner" (e experts
    padded to 8 buckets over 4 shards, one shard's rows), "both", or
    "padded" (no owner, 8 buckets for e < 8 experts).  Returns (kwargs,
    n_buckets)."""
    if case == "padded":
        return {}, 8
    if case == "owner":
        return dict(owner=owner, slots_per_node=2), 8
    tbl = lb.placement_tables(lb.balance_experts([100.0] + [4.0] * (e - 1), 4), 4)
    assert (tbl.fractions > 1e-9).sum(1).max() > 1          # R > 1 in use
    kw = dict(slots_per_node=4,
              rep_node=torch.from_numpy(tbl.rep_node).to(cuda),
              rep_slot=torch.from_numpy(tbl.rep_slot).to(cuda),
              rep_cum=torch.from_numpy(tbl.rep_cum).to(cuda))
    if case == "both":
        kw["owner"] = owner
    return kw, 16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 4, 8, 16, 17, 128])
@pytest.mark.parametrize("case,e,owner", [
    ("tables", 8, None), ("owner", 6, 0), ("owner", 6, 2), ("owner", 6, 3),
    ("both", 8, 0), ("both", 8, 1), ("both", 8, 2), ("both", 8, 3),
    ("padded", 6, None)])
def test_gating_dispatch_kernel_branches_match_plain(cuda, dtype, t, case, e,
                                                     owner):
    """The placement-table and owner-filter branches, one launch (t <=
    16) and two (t > 16), with a bias, 0/1 count weights and a capacity
    below the mean load: idx_buf and counts identical to the plain
    version, gates at 1e-5, two launches bit-identical, and each launch
    counted under its branches."""
    x, w = _dispatch_case(t, 96, e, seed=e)
    xt, wt = _t(x).to(cuda, dtype), _t(w).to(cuda)
    bk, n_buckets = _branch_kwargs(cuda, case, e, owner)
    cap = max(1, t * 2 // e)
    kw = dict(bias=torch.linspace(-0.5, 0.5, e, device=cuda),
              count_weights=(torch.arange(t, device=cuda) % 3 > 0).float(), **bk)
    n0 = dict(gd_mod.KERNEL.variant_launches)
    got = kops.gating_dispatch(xt, wt, 2, n_buckets, cap, **kw)
    again = kops.gating_dispatch(xt, wt, 2, n_buckets, cap, **kw)
    want = gating_dispatch_plain(xt, wt, 2, n_buckets, cap, **kw)
    torch.cuda.synchronize()
    rows = bk.get("slots_per_node", n_buckets) if "owner" in bk else n_buckets
    assert tuple(got[0].shape) == (rows, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    _close(got[1], want[1].cpu().numpy())
    took = {"tables": "rep_node" in bk, "owner": "owner" in bk}
    for v, n in took.items():
        assert gd_mod.KERNEL.variant_launches[v] == n0[v] + 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 17])
def test_gating_dispatch_kernel_largest_tables(cuda, t):
    """256 experts over 16 nodes: (256, 16) tables, 48 KB in shared
    memory beside the cluster kernel's 40 KB of tiles (the launch raises
    its shared-memory limit) and all of the slot kernel's; owner 5's 32
    slots against the plain version."""
    e, nodes = 256, 16
    loads = 1000.0 / np.arange(1, e + 1) ** 1.2
    tbl = lb.placement_tables(lb.balance_experts(loads, nodes), 32)
    assert tbl.rep_node.shape == (e, 16)
    x, w = _dispatch_case(t, 64, e, seed=1)
    xt, wt = _t(x).to(cuda, torch.bfloat16), _t(w).to(cuda)
    kw = dict(owner=5, slots_per_node=32,
              rep_node=torch.from_numpy(tbl.rep_node).to(cuda),
              rep_slot=torch.from_numpy(tbl.rep_slot).to(cuda),
              rep_cum=torch.from_numpy(tbl.rep_cum).to(cuda))
    got = kops.gating_dispatch(xt, wt, 4, nodes * 32, t, **kw)
    want = gating_dispatch_plain(xt, wt, 4, nodes * 32, t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    _close(got[1], want[1].cpu().numpy())


@pytest.mark.cuda
def test_gating_dispatch_kernel_owners_cover_the_tables_path(cuda):
    """The four owners' rows stacked are the no-owner call's buffers with
    the same tables (every entry lands on exactly one node)."""
    x, w = _dispatch_case(12, 64, 8, seed=3)
    xt, wt = _t(x).to(cuda, torch.bfloat16), _t(w).to(cuda)
    bk, n_buckets = _branch_kwargs(cuda, "tables", 8)
    full = kops.gating_dispatch(xt, wt, 2, n_buckets, 12, **bk)
    parts = [kops.gating_dispatch(xt, wt, 2, n_buckets, 12, owner=j, **bk)
             for j in range(4)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([p[0] for p in parts]), full[0])
    assert torch.equal(torch.cat([p[1] for p in parts]), full[1])
    assert all(torch.equal(p[2], full[2]) for p in parts)


@pytest.mark.cuda
def test_gating_dispatch_kernel_hash_rounding_to_one_takes_the_last_replica(cuda):
    """Token 10939236 hashes to u = 1.0 in f32 (h rounds up to 2**32), so
    ``sum(u >= cum)`` reaches R and is clamped to the last replica.  One
    call over T = 10939237 tokens, every token routed to the replicated
    expert 0 (two launches: the slot kernel hashes the token's row in the
    call), against the plain version."""
    T, tok = 10939237, 10939236
    assert float(moe_lib.token_hash01(torch.tensor([tok]))[0]) == 1.0
    x = torch.randn(T, 8, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    w = torch.zeros(8, 4, device=cuda)
    tbl = lb.placement_tables(lb.balance_experts([100.0, 1.0, 1.0, 1.0], 2), 4)
    assert tbl.rep_node[0, 0] != tbl.rep_node[0, 1]
    kw = dict(bias=torch.tensor([10.0, 0.0, 0.0, 0.0], device=cuda),
              slots_per_node=4,
              rep_node=torch.from_numpy(tbl.rep_node).to(cuda),
              rep_slot=torch.from_numpy(tbl.rep_slot).to(cuda),
              rep_cum=torch.from_numpy(tbl.rep_cum).to(cuda))
    got = kops.gating_dispatch(x, w, 1, 8, T, **kw)
    want = gating_dispatch_plain(x, w, 1, 8, T, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    last = int(tbl.rep_node[0, 1]) * 4 + int(tbl.rep_slot[0, 1])
    row = got[0][last]
    assert int(row[(row < T).sum() - 1]) == tok        # the last token's slot
    del x, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,m,k,n", [(1, 8, 16, 8), (2, 100, 60, 28), (8, 4, 512, 300),
                                     (3, 17, 130, 257)])
def test_grouped_matmul_kernel_matches_plain(cuda, dtype, g, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(g, m, k, device=cuda, generator=gen).to(dtype)
    w = (torch.randn(g, k, n, device=cuda, generator=gen) / k ** 0.5).to(dtype)
    got = kops.grouped_matmul(x, w)
    want = grouped_matmul_plain(x, w)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    _close(got, want.float().cpu().numpy(), tol)


def _gm_inputs(cuda, dtype, g, m, k, n, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(g, m, k, device=cuda, generator=gen).to(dtype)
    w = (torch.randn(g, k, n, device=cuda, generator=gen) / k ** 0.5).to(dtype)
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 17, 100])
@pytest.mark.parametrize("k,n", [(130, 257), (256, 264)])
def test_grouped_matmul_kernel_rows(cuda, dtype, m, k, n):
    """Every row-strip width of the kernel, with ragged (element-filled
    stages) and vector-aligned N and K."""
    x, w = _gm_inputs(cuda, dtype, 3, m, k, n)
    n0 = gm_mod.KERNEL.launches
    got = kops.grouped_matmul(x, w)
    want = grouped_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert gm_mod.KERNEL.launches == n0 + 1
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    _close(got, want.float().cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["fma", "mma"])
@pytest.mark.parametrize("m", [1, 4, 17])
@pytest.mark.parametrize("k,n", [(130, 257), (512, 384)])
def test_grouped_matmul_kernel_bodies(cuda, body, m, k, n):
    x, w = _gm_inputs(cuda, torch.bfloat16, 2, m, k, n)
    got = gm_mod.grouped_matmul(x, w, body=body)
    want = grouped_matmul_plain(x, w)
    torch.cuda.synchronize()
    _close(got, want.float().cpu().numpy(), dict(rtol=2e-2, atol=2e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["auto", "fma", "mma"])
@pytest.mark.parametrize("k,n", [(6144, 16384), (16384, 6144)])
def test_grouped_matmul_kernel_path_shapes(cuda, body, k, n):
    """The serving path's up and down projections (8 experts, capacity
    4) in bf16; two launches on the same inputs are bit-identical."""
    x, w = _gm_inputs(cuda, torch.bfloat16, 8, 4, k, n)
    got = gm_mod.grouped_matmul(x, w, body=body)
    again = gm_mod.grouped_matmul(x, w, body=body)
    want = grouped_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, want.float().cpu().numpy(), dict(rtol=2e-2, atol=2e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("m", [16, 33, 64, 128, 200])
@pytest.mark.parametrize("k,n", [(130, 257), (256, 264), (520, 1000)])
def test_grouped_matmul_live_body(cuda, m, k, n, table):
    """The live-row body (bf16, M > 8), with ragged (element-filled) and
    vector-aligned N and K, with and without a dispatch table that holds
    an empty expert and gaps; two launches are bit-identical."""
    x, w = _gm_inputs(cuda, torch.bfloat16, 4, m, k, n)
    kw = {}
    if table:
        counts = (m // 3, 0, m, min(m, 5))
        kw = dict(idx=_table(4, m, m + 3, counts, gap=True).to(cuda), n_tokens=m + 3)
    before = dict(gm_mod.KERNEL.variant_launches)
    got = kops.grouped_matmul(x, w, **kw)
    again = kops.grouped_matmul(x, w, **kw)
    want = grouped_matmul_plain(x, w, **kw)
    torch.cuda.synchronize()
    after = gm_mod.KERNEL.variant_launches
    assert after["wgmma"] == before["wgmma"] + 2
    assert after["live_rows"] == before["live_rows"] + 2 * table
    assert torch.equal(got, again)
    _close(got, want.float().cpu().numpy(), dict(rtol=2e-2, atol=2e-2))
    if table:
        assert not got[1].any() and not got[0, m // 3:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 64])
def test_grouped_matmul_body_by_rows(cuda, dtype, m):
    """bf16 takes the strip bodies up to 8 rows and the live-row body
    above; f32 always the FMA body.  The strip bodies honour the table
    too: rows past an expert's live count, and empty experts, are zeros."""
    x, w = _gm_inputs(cuda, dtype, 3, m, 256, 264)
    idx = _table(3, m, m + 1, (m, 0, (m + 1) // 2)).to(cuda)
    before = dict(gm_mod.KERNEL.variant_launches)
    got = kops.grouped_matmul(x, w, idx=idx, n_tokens=m + 1)
    want = grouped_matmul_plain(x, w, idx=idx, n_tokens=m + 1)
    torch.cuda.synchronize()
    after = gm_mod.KERNEL.variant_launches
    assert after["wgmma"] == before["wgmma"] + (dtype == torch.bfloat16 and m > 8)
    assert after["live_rows"] == before["live_rows"] + 1
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    _close(got, want.float().cpu().numpy(), tol)
    assert not got[1].any() and not got[2, (m + 1) // 2:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(6144, 16384), (16384, 6144)])
def test_grouped_matmul_decode_shapes(cuda, k, n):
    """The benchmark's decode micro-batch (8 experts, C = 64, ~16 live
    rows an expert) through the live-row body with its table against
    the plain version, and bit-identical from launch to launch."""
    x, w = _gm_inputs(cuda, torch.bfloat16, 8, 64, k, n)
    idx = _table(8, 64, 64, (16, 12, 20, 15, 17, 14, 18, 16)).to(cuda)
    x.mul_((idx != 64)[..., None])
    got = kops.grouped_matmul(x, w, idx=idx, n_tokens=64)
    again = kops.grouped_matmul(x, w, idx=idx, n_tokens=64)
    want = grouped_matmul_plain(x, w, idx=idx, n_tokens=64)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, want.float().cpu().numpy(), dict(rtol=2e-2, atol=2e-2))


@pytest.mark.cuda
def test_grouped_matmul_kernel_refuses_a_misaligned_view(cuda):
    x, w = _gm_inputs(cuda, torch.bfloat16, 2, 4, 64, 64)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xm = base[1:].view(x.shape)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.storage_offset() == 1
    with pytest.raises(ValueError, match="16-byte"):
        kops.grouped_matmul(xm, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention",
                                  "gating_topk", "gating_dispatch",
                                  "grouped_matmul"])
def test_cuda_wrappers_refuse_inputs_that_require_grad(cuda, name):
    """The kernels have no backward: each CUDA route raises, before any
    launch, on an input that requires grad while grad mode is on (the
    calls of ``chip_smoke.py``'s phase 1 check)."""
    calls = _chip_smoke().grad_guard_calls(torch, cuda)
    before = cuda_build.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        calls[name]()
    assert cuda_build.launch_counts() == before
