"""The port's three kernels on the serving path: decode_attention,
gating_dispatch, grouped_matmul / grouped_mlp.

On the CPU each wrapper takes its plain PyTorch version; those are held
against the JAX package's Pallas kernels run as its own tests run them
(``repro.kernels.ops`` in interpret mode).  Tolerances: values rtol =
atol = 1e-5 in f32 (the same math summed in another order); dispatch
indices exact; counts and gates at 1e-5 (f32 sums).

Cases marked ``cuda`` hold each CUDA kernel against its plain version on
the card; they skip on a machine without one.  bf16 cases there compare
at 2e-2 (one bf16 rounding of the output plus f32 sums in another
order).  The JAX cases get JAX through a fixture that skips where it is
not installed, so the file also collects on the card's machine.
"""
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gating_dispatch import gating_dispatch_plain
from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
from repro_torch.models.attention import decode_attention as decode_attention_plain

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import load_balance as lb
    from repro.kernels import ops as jops
    return types.SimpleNamespace(jnp=jnp, ops=jops, lb=lb)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
]


@pytest.mark.parametrize("b,h,hkv,hd,w,window,cap", ATTN_CASES)
def test_decode_attention_plain_matches_jax(jx, b, h, hkv, hd, w, window, cap):
    q, k, v, cpos, pos = _attn_case(b, h, hkv, hd, w)
    kw = dict(window=window, attn_softcap=cap)
    got = kops.decode_attention(_t(q), _t(k), _t(v), _t(cpos), _t(pos), **kw)
    a = jx.jnp.asarray
    want = jx.ops.decode_attention(a(q), a(k), a(v), a(cpos), a(pos), **kw)
    _close(got, want)


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


# ---------------------------------------------------------------- build layer
def test_library_name_tracks_the_source():
    """An edited source gets a new library name, so a stale build is
    never loaded."""
    p = cuda_build.library_path("grouped_matmul.cu")
    assert p.parent == cuda_build.BUILD_DIR and p.suffix == ".so"
    assert p != cuda_build.library_path("decode_attention.cu")
    assert set(cuda_build.REGISTRY) == {"decode_attention.cu",
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


# ---------------------------------------------------------------- on the card
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
def test_gating_dispatch_kernel_refuses_tables(cuda):
    x, w = _dispatch_case(8, 16, 4)
    with pytest.raises(NotImplementedError):
        kops.gating_dispatch(_t(x).to(cuda), _t(w).to(cuda), 2, 4, 8, owner=0,
                             slots_per_node=2)


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
