"""The port's dry run (``launch.dryrun``, ``analysis.roofline``,
``analysis.report``) against the JAX package's and against counts made
by hand, on the CPU (meta tensors: nothing is allocated).

  * ``model_flops_estimate`` equals JAX's for every config, shape and
    production mesh; ``shape_eligible`` / ``effective_config`` equal the
    JAX dry run's (compiled from its source: importing the module sets a
    512-device flag);
  * one rank's decode and prefill of reduced qwen2-moe (kv heads over
    "model") and reduced mixtral (slots over "model"), and one rank's
    decode of reduced mamba2 (SSD heads) and recurrentgemma (RG-LRU
    channels, 4 query heads and the local ring's slots), on a (2, 4)
    ``RecordingMesh``: the matrix-product FLOPs and the collective bytes
    by kind equal counts made by hand from the shapes, the argument bytes
    the rank's blocks;
  * a record has the JAX record's keys and the roofline JAX's fields;
  * the report renders its tables from a directory of records;
  * mamba2, recurrentgemma, whisper and llama-vision (once
    "unsupported") come out "ok" on both production meshes;
    ``--seq-parallel`` (once "unsupported") leaves a decode record the
    record without the flag and splits a train or prefill record's
    model-axis sums into all-gathers and reduce-scatters; the JAX-only
    flags are refused;
  * under fsdp the leaves JAX splits on their stacked block dim are
    ``test_torch_sharding.FSDP_BLOCK_DIM``'s, and a rank holds the bytes
    per rank of JAX's rule;
  * the train records JAX fails (``zero_extend`` names the data axes
    twice: ``DuplicateSpecError``) are the port's "FAILED" ones, config
    for config, computed here from the JAX rules on ``eval_shape``
    params; m2n and m2n2d train steps are "ok".
"""
import ast
import dataclasses
import json
import math
import os

import pytest
import torch

from repro_torch.analysis import report as treport
from repro_torch.analysis import roofline as trl
from repro_torch.config import INPUT_SHAPES, ShapeConfig, get_config, reduced
from repro_torch.configs import ASSIGNED, PAPER
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.models.transformer import init_params
from repro_torch.training.optimizer import leaves
from test_torch_sharding import AXES, FSDP_BLOCK_DIM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DRYRUN = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
ARCHS = ASSIGNED + PAPER
MESHES = {"16x16": 256, "2x16x16": 512}
OTHER_KINDS = ["mamba2-1.3b", "recurrentgemma-2b", "whisper-large-v3",
               "llama-3.2-vision-90b"]


def _jax_dryrun_functions(*names):
    """Functions of the JAX dry run's source, compiled without importing
    the module (its first lines force 512 host devices)."""
    from jax.sharding import PartitionSpec

    from repro.config import ModelConfig
    from repro.launch.mesh import data_axes
    with open(JAX_DRYRUN) as fh:
        tree = ast.parse(fh.read())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"dataclasses": dataclasses, "ModelConfig": ModelConfig,
          "data_axes": data_axes, "P": PartitionSpec}
    exec(compile(ast.Module(fns, []), JAX_DRYRUN, "exec"), ns)
    return [ns[n] for n in names]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_estimate_is_the_jax_one(arch):
    pytest.importorskip("jax")
    from repro import config as jconfig
    from repro.analysis import roofline as jrl
    cfg, jcfg = get_config(arch), jconfig.get_config(arch)
    for name, sc in INPUT_SHAPES.items():
        for n_chips in MESHES.values():
            assert trl.model_flops_estimate(cfg, sc, n_chips) == \
                jrl.model_flops_estimate(jcfg, jconfig.INPUT_SHAPES[name], n_chips)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_eligible_and_effective_config_are_the_jax_ones(arch):
    pytest.importorskip("jax")
    from repro import config as jconfig
    eligible, effective = _jax_dryrun_functions("shape_eligible", "effective_config")
    cfg, jcfg = get_config(arch), jconfig.get_config(arch)
    for shape in INPUT_SHAPES:
        assert tdr.shape_eligible(cfg, shape) == eligible(jcfg, shape)
        for chunk in (0, 64):
            got, want = tdr.effective_config(cfg, shape, chunk), effective(jcfg, shape, chunk)
            assert got.block_pattern == want.block_pattern
            assert got.remainder_pattern == want.remainder_pattern
            assert (got.ssm and got.ssm.chunk) == (want.ssm and want.ssm.chunk)


# ---------------------------------------------------------------------------
# one rank's counts against counts made by hand
# ---------------------------------------------------------------------------

GRID = (2, 4)          # (data, model)
DECODE = ShapeConfig("decode_t", "decode", 32, 8)
PREFILL = ShapeConfig("prefill_t", "prefill", 16, 4)
TRAIN = ShapeConfig("train_t", "train", 16, 4)


def _record(arch, shape_cfg):
    cfg = reduced(get_config(arch))
    mesh = RecordingMesh(GRID, ("data", "model"), (1, 2))
    program, args, _ = tdr.build(cfg, shape_cfg, mesh)
    cost, mem, coll, by_axes = tdr.measure(program, args, mesh)
    return cfg, mesh, args, cost, mem, coll, by_axes


def _matmul_flops_by_hand(cfg, kind, b, T, W):
    """The matrix products one rank runs (heads, kv heads, experts and
    vocabulary over the 4 model ranks, b rows): per token the q / k / v /
    o projections of its heads, the router, its experts' three products
    over a drop-free capacity of every token, the shared expert's d_ff
    block and its gate; per row the attention's two products over its
    keys (a prefill's chunk attends to all T keys, masked), and the LM
    head's vocabulary block on the last token."""
    m = GRID[1]
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    n = b * T
    Hl = H // m
    kv_cols = cfg.n_kv_heads * hd        # every kv head (gathered weight) ...
    if cfg.n_kv_heads % m == 0 or kind == "decode":
        kv_cols //= m                    # ... or the rank's kv heads or columns
    # a decode over split slots gathers every head's q; a prefill attends
    # with the rank's heads
    q_heads = H if kind == "decode" and cfg.n_kv_heads % m else Hl
    per_layer = 2 * n * d * (Hl * hd + 2 * kv_cols) + 2 * n * Hl * hd * d
    keys = T if kind == "prefill" else W // (1 if cfg.n_kv_heads % m == 0 else m)
    per_layer += 2 * 2 * n * q_heads * keys * hd
    e = cfg.moe
    per_layer += 2 * n * d * e.n_experts
    per_layer += 3 * 2 * n * d * e.d_ff_expert * (e.n_experts // m)
    if e.n_shared_experts:
        per_layer += 3 * 2 * n * d * (e.d_ff_shared // m) + 2 * n * d
    return len(cfg.layer_kinds) * per_layer + 2 * b * d * (cfg.vocab // m)


def _collective_bytes_by_hand(cfg, b, T):
    """What one rank hands its mesh (bf16 activations, f32 expert
    combine): per layer the sums after wo, the expert combine and the
    shared expert's w2; the embedding's sum and the LM head's zero-filled
    gather; with the slots over "model", the gathered K / V weights (a
    prefill) or every head's q, k and v gathered from the rank's columns
    in one collective and the two merges ("all-reduce-max" of the lse; a
    decode)."""
    m = GRID[1]
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    n = b * T
    per_layer = 2 * n * d + 4 * n * d
    if cfg.moe.n_shared_experts:
        per_layer += 2 * n * d
    out = {"all-reduce": 2 * n * d + 2 * b * cfg.vocab}
    if cfg.n_kv_heads % m and T > 1:
        per_layer += 2 * (2 * d * cfg.n_kv_heads * hd)     # wk, wv gathered
    elif cfg.n_kv_heads % m:
        per_layer += 2 * b * (H + 2 * cfg.n_kv_heads) * hd + 4 * b * H * (hd + 1)
        out["all-reduce-max"] = len(cfg.layer_kinds) * 4 * b * H
    out["all-reduce"] += len(cfg.layer_kinds) * per_layer
    return out


def _recurrent_decode_by_hand(cfg, b, W):
    """(matrix-product FLOPs, collective bytes by kind) of one rank's decode
    step of reduced mamba2 or recurrentgemma over the 4 model ranks, b
    rows (bf16 activations; the SSD conv output, the norm's sum of squares
    and the attention merge in f32):
      * ``ssd``: the rank's in_proj columns, gathered (bf16); the conv
        output gathered (f32); its heads' state read-out (h/m heads, p x
        n); the norm's sum of squares (f32, one per row); out_proj's rows
        and their sum;
      * ``rglru``: w_in_x / w_in_gate / w_a / w_x columns, w_out's rows;
        the conv output gathered and the output summed;
      * ``local`` (1 kv head: the slots split): every head's q, k, v from
        the rank's columns in one gather, all H heads over the rank's W / m
        slots, the merge (a max of the lse, a sum of out and the weights),
        wo's rows of the rank's head columns and their sum;
      * the dense FFN's d_ff block and its sum; the embedding's sum and
        the LM head's zero-filled gather."""
    m = GRID[1]
    d, V = cfg.d_model, cfg.vocab
    flops = 2 * b * d * (V // m)
    coll = {"all-reduce": 2 * b * d + 2 * b * V}
    ffn_flops = 3 * 2 * b * d * (cfg.d_ff // m)
    for kind in cfg.layer_kinds:
        if kind == "ssd":
            s = cfg.ssm
            di, n, h, p = s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim
            P, Cw = 2 * di + 2 * n + h, di + 2 * n
            flops += 2 * b * d * (P // m) + 2 * b * (h // m) * p * n + 2 * b * (di // m) * d
            coll["all-reduce"] += 2 * b * P + 4 * b * Cw + 4 * b + 2 * b * d
        elif kind == "rglru":
            w = cfg.rglru.lru_width
            flops += 2 * 2 * b * d * (w // m) + 2 * 2 * b * w * (w // m)
            flops += 2 * b * (w // m) * d + ffn_flops
            coll["all-reduce"] += 2 * b * w + 2 * b * d + 2 * b * d
        else:
            H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
            flops += 2 * b * d * (H + 2 * Hkv) * hd // m
            flops += 2 * 2 * b * H * (W // m) * hd + 2 * b * (H * hd // m) * d
            flops += ffn_flops
            coll["all-reduce"] += (2 * b * (H + 2 * Hkv) * hd + 4 * b * H * (hd + 1)
                                   + 2 * b * d + 2 * b * d)
            coll["all-reduce-max"] = coll.get("all-reduce-max", 0) + 4 * b * H
    return flops, coll


def _argument_bytes(cfg, mesh, shape_cfg, b, T):
    """The rank's blocks of the params under the "ep" rules (bf16), its
    rows of the tokens, and for decode its cache blocks and positions."""
    full = init_params(cfg, dtype=torch.bfloat16, device="meta")
    specs = tsh.param_specs(cfg, full, mesh)
    want = sum(t.numel() * t.element_size()
               for t in leaves(tsh.shard_tree(full, specs, mesh)))
    want += b * (1 if shape_cfg.kind == "decode" else T) * 4
    if shape_cfg.kind == "decode":
        from repro_torch.models import stubs
        cache = stubs.cache_specs(cfg, shape_cfg.global_batch, shape_cfg.seq_len,
                                  mesh=mesh)
        want += sum(t.numel() * t.element_size() for e in cache for t in e.values())
        want += b * 4                                       # pos
    return want


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_recurrent_decode_flops_and_collective_bytes_are_the_counts_by_hand(arch):
    cfg, mesh, args, cost, mem, coll, by_axes = _record(arch, DECODE)
    b = DECODE.global_batch // GRID[0]
    W = min(cfg.window, DECODE.seq_len)
    flops, want = _recurrent_decode_by_hand(cfg, b, W)
    assert cost["flops"] == flops
    assert coll == want
    assert set(by_axes) == {"model"}
    assert mem["argument_size"] == _argument_bytes(cfg, mesh, DECODE, b, 1)
    # the cache blocks: the rank's channels / heads / slots of each entry
    for entry, kind in zip(args[2], cfg.layer_kinds):
        if kind == "ssd":
            assert entry["ssm"].shape[1] == cfg.ssm.n_heads(cfg.d_model) // GRID[1]
        elif kind == "rglru":
            assert entry["h"].shape[1] == cfg.rglru.lru_width // GRID[1]
        else:
            assert entry["k"].shape[1] == W // GRID[1]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b"])
@pytest.mark.parametrize("shape_cfg", [DECODE, PREFILL], ids=["decode", "prefill"])
def test_flops_and_collective_bytes_are_the_counts_by_hand(arch, shape_cfg):
    cfg, mesh, args, cost, mem, coll, by_axes = _record(arch, shape_cfg)
    b = shape_cfg.global_batch // GRID[0]
    T = 1 if shape_cfg.kind == "decode" else shape_cfg.seq_len
    assert cost["flops"] == _matmul_flops_by_hand(cfg, shape_cfg.kind, b, T,
                                                  shape_cfg.seq_len)
    assert coll == _collective_bytes_by_hand(cfg, b, T)
    assert set(by_axes) == {"model"}
    want = _argument_bytes(cfg, mesh, shape_cfg, b, T)
    assert mem["argument_size"] == want
    assert 0 < mem["temp_size"] and cost["bytes accessed"] > want


def test_a_record_has_the_jax_keys_and_the_report_renders(tmp_path, capsys):
    pytest.importorskip("jax")
    from repro.analysis import roofline as jrl
    with open(JAX_DRYRUN) as fh:
        tree = ast.parse(fh.read())
    run_one = next(n for n in tree.body
                   if isinstance(n, ast.FunctionDef) and n.name == "run_one")
    rec_keys = next({k.value for k in n.value.keys}
                    for n in ast.walk(run_one)
                    if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                    and getattr(n.targets[0], "id", "") == "rec")
    out = str(tmp_path)
    recs = [tdr.run_one("granite-3-8b", "decode_32k", mp, out_dir=out, verbose=False)
            for mp in (False, True)]
    recs.append(tdr.run_one("granite-3-8b", "long_500k", False, out_dir=out))
    recs.append(tdr.run_one("granite-3-8b", "decode_32k", False, seq_parallel=True,
                            out_dir=out))
    recs.append(tdr.run_one("mamba2-1.3b", "decode_32k", False, out_dir=out))
    ok = recs[0]
    assert rec_keys <= set(ok), rec_keys - set(ok)
    jax_fields = set(jrl.Roofline.__dataclass_fields__) | {
        "t_compute", "t_memory", "t_collective", "bottleneck",
        "useful_flops_ratio", "step_time_bound", "mfu_bound"}
    assert set(ok["roofline"]) == jax_fields
    assert set(ok["memory_analysis"]) >= {"argument_size", "output_size", "temp_size"}
    assert set(ok["cost_analysis"]) == {"flops", "bytes accessed", "transcendentals"}
    assert [r["status"] for r in recs] == ["ok", "ok", "skipped", "ok", "ok"]
    for r in recs[:2]:
        json.dumps(r)
        assert r["roofline"]["n_chips"] == MESHES[r["mesh"]]
        assert r["roofline"]["hbm_bw"] == 3.35e12 and r["roofline"]["ici_bw"] == 900e9
    assert len(os.listdir(out)) == 5
    capsys.readouterr()
    import sys
    argv, sys.argv = sys.argv, ["report", out]
    try:
        treport.main()
    finally:
        sys.argv = argv
    text = capsys.readouterr().out
    assert "## §Roofline" in text and "## §Dry-run" in text
    assert "| granite-3-8b | decode_32k |" in text
    assert "| granite-3-8b | decode_32k | 16x16 | ok |" in text
    assert "unsupported" not in text
    assert "| mamba2-1.3b | decode_32k | 16x16 | ok |" in text
    assert "| granite-3-8b | long_500k | 16x16 | skipped |" in text


@pytest.mark.parametrize("arch", OTHER_KINDS)
def test_the_other_kinds_are_unsupported_with_the_reason(arch, tmp_path):
    """Once "unsupported" (no model axis for their layer kinds): a rank's
    decode of each now runs on both production meshes (128 rows split
    over the data axes, its collectives over "model" only), its matrix
    products counted."""
    for multi_pod in (False, True):
        rec = tdr.run_one(arch, "decode_32k", multi_pod, out_dir=str(tmp_path),
                          verbose=False)
        assert rec["status"] == "ok", rec.get("note")
        assert rec["cost_analysis"]["flops"] > 0
        assert set(rec["collectives_by_axes"]) == {"model"}


def test_seq_parallel_is_unsupported_and_jax_only_flags_are_refused(tmp_path):
    """Once "unsupported": a decode record under ``--seq-parallel`` is the
    record without it (JAX's ``ACT_SPEC`` never reaches a decode step);
    a train and a prefill record split the model-axis sums of the block
    periods into reduce-scatters and all-gathers over the sequence, with
    the FLOPs of the record without the flag."""
    keep = ("cost_analysis", "memory_analysis", "collectives_by_axes", "roofline")
    rec = tdr.run_one("granite-3-8b", "decode_32k", False, seq_parallel=True,
                      out_dir=str(tmp_path), verbose=False)
    base = tdr.run_one("granite-3-8b", "decode_32k", False, out_dir=str(tmp_path),
                       verbose=False)
    assert rec["status"] == "ok"
    assert {k: rec[k] for k in keep} == {k: base[k] for k in keep}
    assert os.path.exists(tmp_path / "granite-3-8b_decode_32k_single_baseline_full_seqpar.json")
    cfg = reduced(get_config("minitron-4b"))
    for shape in (TRAIN, PREFILL):
        (cost, _, coll, _), (cost0, _, coll0, _) = (
            tdr.measure(*tdr.build(cfg, shape, mesh, seq_parallel=sp)[:2], mesh)
            for sp in (True, False)
            for mesh in [RecordingMesh(GRID, ("data", "model"), (1, 2))])
        assert coll.get("all-gather", 0) > 0 and coll.get("reduce-scatter", 0) > 0, coll
        assert "all-gather" not in coll0 and "reduce-scatter" not in coll0
        assert cost["flops"] == cost0["flops"]
    for flag in ("--save-hlo", "--no-unroll"):
        with pytest.raises(SystemExit):
            tdr.main(["--arch", "granite-3-8b", "--shape", "decode_32k", flag,
                      "--out", str(tmp_path)])


@pytest.mark.parametrize("axes", AXES, ids=["16x16", "2x16x16"])
def test_fsdp_block_dim_leaves_and_bytes_per_rank(axes):
    """The leaves ``jax_block_dim`` places are FSDP_BLOCK_DIM's (held
    there against the JAX rules); minitron-8b's and scaled-moe's ranks
    hold JAX's fsdp bytes per rank (its specs over the stacked tree)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.launch import sharding as jsh
    from repro.models import transformer as jtf
    name = "16x16" if len(axes) == 2 else "2x16x16"
    for arch in ARCHS:
        cfg = get_config(arch)
        mesh = RecordingMesh.named(name)
        full = init_params(cfg, device="meta")
        got = set()
        for path, _ in tdr._paths(full):
            if tdr.jax_block_dim(cfg, path, mesh) is not None:
                leaf = path.split("/")[-1]
                got.add("encoder/" + leaf if path.startswith("encoder/") else leaf)
        assert got == FSDP_BLOCK_DIM.get((arch, axes), set()), arch
    for arch in ("minitron-8b", "scaled-moe"):
        cfg, jcfg = get_config(arch), jconfig.get_config(arch)
        structs = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0),
                                                         jnp.bfloat16))
        mesh = RecordingMesh.named(name, (0,) * len(axes))
        jspecs = jsh.param_specs(jcfg, structs, mesh, fsdp=True)
        want = 0
        for st, sp in zip(jax.tree.leaves(structs),
                          jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))):
            split = math.prod(tsh._axis_size(mesh, a) for a in sp)
            want += math.prod(st.shape) * st.dtype.itemsize // split
        for coords in ((0,) * len(axes), (1,) + (0,) * (len(axes) - 1)):
            mesh = RecordingMesh.named(name, coords)
            held, _, on_block = tdr.place_params(cfg, mesh, fsdp=True)
            got = sum(t.numel() * t.element_size() for t in leaves(held)
                      if t is not None)
            assert got == want, (arch, coords, got, want)
            assert bool(on_block) == ((arch, axes) in FSDP_BLOCK_DIM)


def test_fsdp_decode_gathers_the_data_blocks(tmp_path):
    rec = tdr.run_one("minitron-8b", "decode_32k", False, fsdp=True,
                      out_dir=str(tmp_path), verbose=False)
    base = tdr.run_one("minitron-8b", "decode_32k", False, out_dir=str(tmp_path),
                       verbose=False)
    assert rec["status"] == base["status"] == "ok"
    assert rec["fsdp_block_dim"] and not base["fsdp_block_dim"]
    assert set(rec["collectives_by_axes"]) == {"model", "data"}
    assert rec["memory_analysis"]["argument_size"] < base["memory_analysis"]["argument_size"]
    assert rec["cost_analysis"]["flops"] == base["cost_analysis"]["flops"]


@pytest.mark.parametrize("moe_impl", ["m2n", "m2n2d"])
def test_m2n_serving_runs_on_the_recording_mesh(moe_impl, tmp_path):
    """``core.m2n`` over "model" runs in a rank's decode (each rank its
    expert shard; under m2n2d its data rank's d_ff block too, the rows
    gathered over the data axes); its train step (once "unsupported")
    runs too, the experts' sums over "model" and the gradients' over the
    data axes: with ZeRO-1, as in JAX's train record, each gradient
    reduce-scattered to its moment's block and the params all-gathered
    back."""
    base = tdr.run_one("mixtral-8x22b", "decode_32k", False, out_dir=str(tmp_path),
                       verbose=False)
    rec = tdr.run_one("mixtral-8x22b", "decode_32k", False, moe_impl=moe_impl,
                      out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok" and rec["moe_impl"] == moe_impl
    assert rec["cost_analysis"]["flops"] > 0
    args, args0 = (r["memory_analysis"]["argument_size"] for r in (rec, base))
    # 8 experts on 16 ranks: the "ep" rule splits their d_ff 16 ways, m2n
    # gives rank 0 one whole expert; m2n2d cuts its d_ff over the 16 data
    # ranks; the counts (m2n) or the rows (m2n2d) cross the data axes
    assert args == args0 + 56 * 3 * 6144 * 16384 * 2 * (1 - 8 / 16) \
        if moe_impl == "m2n" else args < args0
    assert set(rec["collectives_by_axes"]) == {"model", "data"}
    mesh = RecordingMesh(GRID, ("data", "model"), (1, 2))
    cost, _, kinds, by_axes = tdr.measure(*tdr.build(
        reduced(get_config("mixtral-8x22b")), TRAIN, mesh, moe_impl=moe_impl)[:2], mesh)
    assert cost["flops"] > 0
    assert set(by_axes) >= {"model", "data"}
    assert {"reduce-scatter", "all-gather"} <= set(kinds), kinds


# the JAX dry run's train records that raise DuplicateSpecError (checked
# below from the JAX rules): (flags, the configs)
JAX_REFUSED = {
    "fsdp": {"minitron-4b", "minitron-8b", "whisper-large-v3", "arctic-480b", "dbrx",
             "scaled-moe"},
    "ep2d": {"arctic-480b", "dbrx", "scaled-moe"},
}


@pytest.mark.parametrize("axes", AXES, ids=["16x16", "2x16x16"])
def test_train_records_jax_refuses_are_failed_with_its_words(axes, tmp_path, capsys):
    """For every config under ``--fsdp``, ``--expert-shard ep2d`` and both:
    JAX's duplicate-axes leaves (``param_specs`` of its ``eval_shape``
    params, the dry run's own ``zero_extend``, a spec naming an axis
    twice) are counted here; the port's train layout raises
    ``DuplicateSpecError`` with JAX's words exactly where that count is
    not 0 (the configs of ``JAX_REFUSED``), and ``main`` writes such a
    record "FAILED" and exits 1, as the JAX dry run does."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro import config as jconfig
    from repro.launch import sharding as jsh
    from repro.models import transformer as jtf
    from test_torch_sharding import FakeMesh
    (zero_extend,) = _jax_dryrun_functions("zero_extend")
    name = "16x16" if len(axes) == 2 else "2x16x16"
    jmesh = FakeMesh(axes)
    mesh = RecordingMesh.named(name)
    for flags, kw in (("fsdp", dict(fsdp=True)), ("ep2d", dict(expert_mode="ep2d")),
                      ("both", dict(fsdp=True, expert_mode="ep2d"))):
        refused = set()
        for arch in ARCHS:
            jcfg = jconfig.get_config(arch)
            structs = jax.eval_shape(lambda: jtf.init_params(
                jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
            specs = jsh.param_specs(jcfg, structs, jmesh, **kw)
            bad = []
            for st, sp in zip(jax.tree.leaves(structs), jax.tree.leaves(
                    specs, is_leaf=lambda x: isinstance(x, PartitionSpec))):
                z = zero_extend(sp, st.shape, jmesh)
                names = [a for ax in z if ax is not None
                         for a in (ax if isinstance(ax, tuple) else (ax,))]
                if len(names) != len(set(names)):
                    bad.append(z)
            try:
                tsh.Layout(get_config(arch), mesh, zero=True, **kw)
                got = None
            except tsh.DuplicateSpecError as e:
                got = str(e)
            assert (got is not None) == bool(bad), (flags, arch, len(bad), got)
            if bad:
                refused.add(arch)
                # JAX's own words for one of its offending specs
                devs = jax.numpy.zeros(1).devices()
                try:
                    NamedSharding(jax.sharding.Mesh(
                        __import__("numpy").array(list(devs)).reshape(
                            (1,) * len(axes)), axes), bad[0])
                except Exception as e:  # noqa: BLE001
                    words = str(e)
                assert got.split(" but ")[0] == words.split(" but ")[0], (got, words)
                assert got.endswith("has duplicate entries for `" + axes[-2]
                                    + "`") or "duplicate entries for `pod`" in got, got
        want = (JAX_REFUSED["fsdp"] | JAX_REFUSED["ep2d"] if flags == "both"
                else JAX_REFUSED[flags])
        assert refused == want, (flags, name, sorted(refused))
    capsys.readouterr()
    with pytest.raises(SystemExit) as ex:
        tdr.main(["--arch", "minitron-4b,granite-3-8b", "--shape", "train_4k", "--fsdp",
                  "--out", str(tmp_path)])
    assert ex.value.code == 1
    out = capsys.readouterr().out
    assert "[minitron-4b x train_4k] FAILED: A single NamedSharding spec" in out
    assert "1 ok, 0 skipped, 0 unsupported, 1 failed" in out
