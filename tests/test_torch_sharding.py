"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``) for every config of
``ASSIGNED + PAPER`` on the production mesh sizes of
``tests/test_sharding_rules.py`` ((16, 16) and (2, 16, 16), a duck-typed
mesh), in the modes ep, ep2d and fsdp:

  * each per-layer leaf's spec equals JAX's spec of the stacked leaf
    with its block dim dropped, except under fsdp where JAX shards that
    block dim (``FSDP_BLOCK_DIM``, held to be exactly those leaves);
  * the same for the cache specs at every decode shape, ``input_spec``
    and ``zero_extend``;
  * every spec divides its dim;
  * the meta-device stubs have JAX's shapes and dtypes.

``local_shard`` / ``gather_full`` round-trip on 4 gloo ranks
(``tests/_torch_dist_worker.py shard``).
"""
import ast
import os

import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.configs import ASSIGNED, PAPER
from repro_torch.launch import sharding as tsh
from repro_torch.launch.dist_smoke import run_ranks
from repro_torch.models import stubs as tstubs
from repro_torch.models.transformer import init_params
from repro_torch.training.optimizer import named_leaves

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")
PROD_SIZES = {"data": 16, "model": 16, "pod": 2}
AXES = [("data", "model"), ("pod", "data", "model")]
MODES = [("ep", False), ("ep2d", False), ("ep", True)]

_ATTN = {"wq", "wk", "wv", "wo"}
_DENSE = {"w1", "w2", "w3"}
# under fsdp JAX shards the stacked block dim (n_blocks) of these leaves
# over the data axes, its first free dim that divides; the port's
# per-layer leaves have no such dim (a dry run of the port must place
# them otherwise): {(arch, axes): leaves}
FSDP_BLOCK_DIM = {}
for _axes in AXES:
    for _arch in ("minitron-4b", "minitron-8b"):
        FSDP_BLOCK_DIM[_arch, _axes] = _ATTN | _DENSE
    FSDP_BLOCK_DIM["whisper-large-v3", _axes] = (
        _ATTN | _DENSE | {"c_" + k for k in _ATTN}
        | {"encoder/" + k for k in _ATTN | _DENSE})
FSDP_BLOCK_DIM["scaled-moe", AXES[0]] = _ATTN | {"we1", "we2", "we3"}


class FakeMesh:
    """Duck-typed mesh of the production sizes: ``shape`` and
    ``axis_names``, which is all the rules read."""

    def __init__(self, axes):
        self.axis_names = axes
        self.shape = {a: PROD_SIZES[a] for a in axes}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import types

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from repro import config as jconfig
    from repro.launch import sharding as jsh
    from repro.launch.mesh import data_axes
    from repro.models import stubs as jstubs
    from repro.models import transformer as jtf

    # ``repro.launch.dryrun`` sets a 512-device XLA flag when imported, so
    # its ``zero_extend`` is compiled from the module's source instead
    path = os.path.join(os.path.dirname(jsh.__file__), "dryrun.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "zero_extend")
    ns = {"P": PartitionSpec, "data_axes": data_axes}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig, sh=jsh,
                                 stubs=jstubs, tf=jtf, P=PartitionSpec,
                                 zero_extend=ns["zero_extend"])


def _norm(spec, ndim):
    """A spec (JAX's or the port's) as a tuple of one entry per dim, an
    entry of one axis as its name (newer JAX writes ("data",) so)."""
    one = lambda ax: ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
    return tuple(one(ax) for ax in spec) + (None,) * (ndim - len(spec))


def _divides(spec, shape, mesh):
    for ax, dim in zip(spec, shape):
        if ax is not None:
            assert dim % tsh._axis_size(mesh, ax) == 0, (spec, shape)


def _jax_per_layer(jspecs, jshapes, cfg):
    """{port leaf path: (JAX spec of the leaf, one entry per dim, block
    dim dropped; the entry JAX gave the block dim, or None)}."""
    out = {}
    P = len(cfg.block_pattern)
    for k in ("embed", "final_norm", "lm_head"):
        if k in jspecs:
            out[k] = (_norm(jspecs[k], len(jshapes[k].shape)), None)
    for pat, blk in enumerate(jspecs["blocks"]):
        for name, sp in blk.items():
            full = _norm(sp, len(jshapes["blocks"][pat][name].shape))
            for b in range(cfg.n_blocks):
                out[f"layers/{b * P + pat}/{name}"] = (full[1:], full[0])
    for i, lay in enumerate(jspecs["remainder"]):
        for name, sp in lay.items():
            shape = jshapes["remainder"][i][name].shape
            out[f"layers/{cfg.n_blocks * P + i}/{name}"] = (_norm(sp, len(shape)),
                                                            None)
    if "encoder" in jspecs:
        enc, shapes = jspecs["encoder"], jshapes["encoder"]
        for name, sp in enc["blocks"].items():
            full = _norm(sp, len(shapes["blocks"][name].shape))
            for i in range(cfg.encoder.n_layers):
                out[f"encoder/layers/{i}/{name}"] = (full[1:], full[0])
        for k in ("pos_embed", "final_norm"):
            out[f"encoder/{k}"] = (_norm(enc[k], len(shapes[k].shape)), None)
    return out


@pytest.mark.parametrize("axes", AXES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED + PAPER)
def test_param_specs_are_the_jax_rules(jx, arch, axes):
    mesh = FakeMesh(axes)
    jcfg, cfg = jx.config.get_config(arch), tconfig.get_config(arch)
    jshapes = jx.jax.eval_shape(
        lambda: jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0), jx.jnp.bfloat16))
    params = init_params(cfg, 0, torch.bfloat16, device="meta")
    shapes = {k: tuple(t.shape) for k, t in named_leaves(params)}
    for mode, fsdp in MODES:
        want = _jax_per_layer(jx.sh.param_specs(jcfg, jshapes, mesh,
                                                expert_mode=mode, fsdp=fsdp),
                              jshapes, cfg)
        got = dict(tsh.named_specs(tsh.param_specs(cfg, params, mesh,
                                                   expert_mode=mode, fsdp=fsdp)))
        assert got.keys() == want.keys() == shapes.keys()
        on_block = set()
        for k, sp in got.items():
            assert isinstance(sp, tsh.Spec) and len(sp) == len(shapes[k]), (k, sp)
            _divides(sp, shapes[k], mesh)
            jspec, block_ax = want[k]
            if block_ax is not None:
                leaf = k.split("/")[-1]
                on_block.add("encoder/" + leaf if k.startswith("encoder/") else leaf)
                continue
            assert _norm(sp, len(sp)) == jspec, (arch, mode, fsdp, k, sp, jspec)
        want_on_block = FSDP_BLOCK_DIM.get((arch, axes), set()) if fsdp else set()
        assert on_block == want_on_block, (arch, mode, fsdp, on_block)


@pytest.mark.parametrize("axes", AXES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED + PAPER)
def test_cache_input_and_moment_specs_are_the_jax_rules(jx, arch, axes):
    mesh = FakeMesh(axes)
    jcfg, cfg = jx.config.get_config(arch), tconfig.get_config(arch)
    for name, sc in jx.config.INPUT_SHAPES.items():
        if sc.kind != "decode" or (name == "long_500k"
                                   and not cfg.supports_long_context):
            continue
        B, S = sc.global_batch, sc.seq_len
        jshapes = jx.stubs.cache_specs(jcfg, B, S)
        shapes = tstubs.cache_specs(cfg, B, S)
        want = jx.sh.cache_specs(jcfg, jshapes, mesh, B)
        got = tsh.cache_specs(cfg, shapes, mesh, B)
        P = len(cfg.block_pattern)
        for i, entry in enumerate(got):
            b, pat = divmod(i, P)
            if b < cfg.n_blocks:
                jentry, jshape, drop = want["blocks"][pat], jshapes["blocks"][pat], 1
            else:
                jentry = want["remainder"][i - cfg.n_blocks * P]
                jshape, drop = jshapes["remainder"][i - cfg.n_blocks * P], 0
            assert entry.keys() == jentry.keys()
            for k, sp in entry.items():
                assert tuple(shapes[i][k].shape) == jshape[k].shape[drop:], k
                assert shapes[i][k].dtype == getattr(torch, str(jshape[k].dtype)), k
                full = _norm(jentry[k], len(jshape[k].shape))
                assert full[:drop] == (None,) * drop, (k, full)
                assert _norm(sp, len(sp)) == full[drop:], (arch, name, i, k, sp, full)
                _divides(sp, shapes[i][k].shape, mesh)
        toks = (B, S)
        for shape in (toks, (1,)):
            assert (_norm(tsh.input_spec(shape, mesh), len(shape))
                    == _norm(jx.sh.input_spec(shape, mesh), len(shape)))
    # ZeRO-1 moments: the JAX dry run's zero_extend on the per-layer leaves
    params = init_params(cfg, 0, torch.bfloat16, device="meta")
    specs = dict(tsh.named_specs(tsh.param_specs(cfg, params, mesh)))
    for k, p in named_leaves(params):
        shape = tuple(p.shape)
        got = tsh.zero_extend(specs[k], shape, mesh)
        want = _norm(jx.zero_extend(jx.P(*specs[k]), shape, mesh), len(shape))
        assert _norm(got, len(shape)) == want, (k, got, want)
        _divides(got, shape, mesh)


@pytest.mark.parametrize("arch", ASSIGNED + PAPER)
def test_meta_stubs_have_the_jax_shapes(jx, arch):
    jcfg, cfg = jx.config.get_config(arch), tconfig.get_config(arch)
    for dtype in ("bfloat16", "float32"):
        want = jx.stubs.extra_input_specs(jcfg, 3, getattr(jx.jnp, dtype))
        got = tstubs.extra_input_specs(cfg, 3, getattr(torch, dtype))
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.is_meta and tuple(t.shape) == want[k].shape, k
            assert t.dtype == getattr(torch, dtype)
    jc = jx.stubs.cache_specs(jcfg, 2, 32, jx.jnp.float32)
    tc = tstubs.cache_specs(cfg, 2, 32, torch.float32)
    assert len(tc) == cfg.n_layers
    n_stacked = cfg.n_blocks * len(cfg.block_pattern)
    for i, entry in enumerate(tc):
        src = (jc["blocks"][i % len(cfg.block_pattern)] if i < n_stacked
               else jc["remainder"][i - n_stacked])
        drop = 1 if i < n_stacked else 0
        assert entry.keys() == src.keys()
        for k, t in entry.items():
            assert t.is_meta and tuple(t.shape) == src[k].shape[drop:], (i, k)
            assert t.dtype == getattr(torch, str(src[k].dtype)), (i, k)


def test_local_shard_and_gather_full_round_trip_on_four_ranks(tmp_path):
    out = run_ranks([WORKER, "shard", str(tmp_path)], 4, timeout=120,
                    coordinator=f"file://{tmp_path}/store")
    for rank, (rc, text) in enumerate(out):
        assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"
    blocks = [np.load(tmp_path / f"shard{r}.npz") for r in range(4)]
    # (2, 2) grid, a (8, 6) tensor split over both axes on dim 0: the
    # ranks' blocks tile it in row-major order of ("data", "model")
    full = np.arange(48, dtype=np.float32).reshape(8, 6)
    for r in range(4):
        np.testing.assert_array_equal(blocks[r]["both"], full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(blocks[r]["model_cols"],
                                      full[:, 3 * (r % 2):3 * (r % 2) + 3])
