"""The dry run of the port: one rank's program on a production grid, for
every (arch x input shape x mesh), run on the ``meta`` device (shapes
only: no memory, no card), with its FLOPs, bytes, collectives and memory
counted, and the roofline of ``analysis.roofline`` over them.  The JAX
package's ``launch/dryrun.py`` lowers and compiles the sharded step on
512 placeholder devices and reads XLA's analyses; here one rank's
program runs eagerly under ``launch.mesh.RecordingMesh`` (the grid of
"16x16" or "2x16x16", this rank at a coordinate of it, every collective
recorded and returned unchanged):

  * train: ``training.loop.make_train_step(mesh=...)``, forward, backward
    and the AdamW update, on the rank's blocks of the params and moments
    under the record's layout (``launch.sharding.Layout``: the "ep"
    rules, ``--fsdp``, ``--expert-shard ep2d``, ``--moe-impl m2n|m2n2d``,
    ``--seq-parallel``; the moments under ``zero_extend`` (ZeRO-1), as
    in every JAX train record, but for the layout of the default flags,
    whose records keep the full moments and all-reduced gradients they
    had before the port ran the other layouts);
  * prefill: ``transformer.prefill`` on the rank's rows (its block of the
    sequence between the block periods' layers under ``--seq-parallel``);
  * decode: ``transformer.decode_step``, one new token against a seq_len
    cache in the rank's layout (``stubs.cache_specs(mesh=...)``); JAX's
    ``ACT_SPEC`` never reaches a decode step, so ``--seq-parallel``
    leaves it the program without the flag.

Counted per rank: FLOPs (``torch.utils.flop_counter.FlopCounterMode``),
bytes accessed (the input and output bytes of every aten op but views),
transcendental elements, collective bytes by kind and by axes (the
mesh's record), argument bytes (the rank's params, moments, tokens and
cache blocks), output bytes (the tensors returned) and temp bytes (the
peak of live intermediate tensors, each storage counted once while any
tensor on it lives).  The record keeps the JAX record's keys; its
``t_lower_s`` is the time to place the rank's arguments and
``t_compile_s`` the time of the meta run.

Each record is "ok", "skipped" (the JAX package's reasons),
"unsupported" with its reason (a layer kind without a model axis,
``parallel.check_kinds``; every kind of the registry has one), or, in
``main``, "FAILED" where the JAX dry run fails too: a train record whose
``zero_extend`` names the data axes twice (``sharding.DuplicateSpecError``,
JAX's words), and m2n2d where the data ranks do not divide an expert's
d_ff (JAX's ``shard_map`` refuses the weights).  Serving under
``--moe-impl m2n`` / ``m2n2d`` runs ``core.m2n`` over "model"
(``weights_2d`` with each expert's d_ff split over the data axes), each
rank holding its m2n shard of the experts.  Serving under ``--fsdp`` /
``ep2d`` makes each leaf that the rule splits over the data axes whole
at the start of the pass (``Layout.use_all``: an all-gather, recorded);
a leaf JAX splits on its stacked block dim (the port's per-layer tree
has none) is held whole by the data rank that holds that block, and
sent from it (a zero-filled ``all_reduce``).  The JAX flags
``--save-hlo`` and ``--no-unroll`` have no meaning here and are
refused.

Usage (on the CPU; meta tensors need no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out DIR
  PYTHONPATH=src python -m repro_torch.analysis.report DIR
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.config import INPUT_SHAPES, ModelConfig, ShapeConfig, get_config
from repro_torch.configs import ASSIGNED, PAPER
from repro_torch.core import m2n
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import RecordingMesh, data_axes
from repro_torch.models import parallel, stubs
from repro_torch.models.transformer import decode_step, init_params, prefill
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import AdamWConfig, leaves

DTYPE = torch.bfloat16
META = torch.device("meta")
MESH_NAMES = {False: "16x16", True: "2x16x16"}
zero_extend = shlib.zero_extend

_TRANSCENDENTAL = {"exp", "exp_", "log", "log_", "tanh", "sigmoid", "rsqrt",
                   "sqrt", "sin", "cos", "erf", "silu", "gelu", "logsumexp",
                   "_softmax", "_log_softmax", "softmax", "log_softmax"}


def shape_eligible(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.supports_long_context
    return True


def effective_config(cfg: ModelConfig, shape: str,
                     ssd_chunk: int = 0) -> ModelConfig:
    """Per-shape architecture variants (the JAX package's)."""
    if shape == "long_500k" and cfg.name == "gemma2-27b":
        # 500k decode runs every layer with the sliding-window kernel:
        # global-attention layers would need a 524k-token KV cache
        cfg = dataclasses.replace(cfg, block_pattern=("local", "local"))
    if ssd_chunk and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssd_chunk))
    return cfg


def unsupported_reason(cfg: ModelConfig, shape_cfg: ShapeConfig, mesh, *,
                       moe_impl, expert_mode, fsdp, seq_parallel):
    """Why the port cannot run this record's program, or None."""
    try:
        parallel.check_kinds(cfg.layer_kinds)
    except NotImplementedError as e:
        return str(e)
    return None


def check_m2n2d(cfg: ModelConfig, mesh):
    """Raise as JAX's ``shard_map`` does where m2n2d's weights (each
    expert's d_ff over the data axes) do not split."""
    n = mesh.size(data_axes(mesh))
    f = cfg.moe.d_ff_expert
    if f % n:
        raise ValueError(
            "shard_map applied to the function 'local_fn' was given argument "
            "arrays with axis sizes that are not evenly divisible by the "
            "corresponding mesh axis sizes: in_specs[4] maps array axis 2 (of "
            f"size {f}) to mesh axis {data_axes(mesh)} (of size {n}), but {n} "
            f"does not evenly divide {f}")


# ---------------------------------------------------------------------------
# the rank's arguments
# ---------------------------------------------------------------------------


def _paths(tree, prefix=""):
    """(path, leaf) of a params tree in walk order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def jax_block_dim(cfg: ModelConfig, path: str, mesh, expert_mode: str = "ep"):
    """The stacked block a JAX fsdp rule splits over the data axes for the
    per-layer leaf at ``path`` (the JAX package stacks a block period's
    layers on a leading dim, which fsdp takes first where the data axes'
    size divides it), as (block, blocks), or None where fsdp takes
    another dim there (``sharding.Layout``'s "owner" leaves)."""
    coords = tuple(mesh.index(a) for a in mesh.axis_names)
    owners = _fsdp_owners(cfg, tuple(mesh.shape.values()), mesh.axis_names, coords,
                          expert_mode)
    return shlib.jax_stacking(cfg, path) if path in owners else None


@functools.lru_cache(maxsize=None)
def _fsdp_owners(cfg, shape, axes, coords, expert_mode):
    lay = shlib.Layout(cfg, RecordingMesh(shape, axes, coords),
                       expert_mode=expert_mode, fsdp=True)
    return frozenset(lf.path for lf in lay.leaves if lf.held == "owner")


def place_params(cfg: ModelConfig, mesh, *, expert_mode="ep", fsdp=False,
                 moe_impl="baseline"):
    """(held, assemble, on_block) of a serving record: the meta tensors
    this rank holds as arguments (a tree of the params' structure, empty
    for a leaf another data rank holds), a function that turns them into
    the tree the model code reads (the "ep" rules' blocks, m2n's expert
    shard) inside the counted program, and the paths of the leaves JAX
    fsdp splits on their block dim (``sharding.Layout``)."""
    lay = shlib.Layout(cfg, mesh, expert_mode=expert_mode, fsdp=fsdp,
                       moe_impl=moe_impl)
    held = lay.place_tree(init_params(cfg, dtype=DTYPE, device=META))
    on_block = [lf.path for lf in lay.leaves if lf.held == "owner"]
    return held, lay.use_all, on_block


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    seen, n = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                n += t.untyped_storage().nbytes()
    return n


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------


class OpCounter(TorchDispatchMode):
    """Counts, over every aten op it sees: the input and output bytes of
    each op but views ("bytes accessed"), the elements of transcendental
    ops' outputs, and the peak bytes of live storages made inside it
    (each storage once, while any tensor on it lives; the storages of
    ``args`` are arguments, not temps)."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0
        self.args = {t.untyped_storage()._cdata for t in tree_leaves(args)
                     if isinstance(t, torch.Tensor)}
        self.live = 0
        self.peak = 0
        self._refs = {}

    def _drop(self, key):
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _track(self, t):
        key = t.untyped_storage()._cdata
        if key in self.args:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ref[0]
            self.peak = max(self.peak, self.live)
        ref[1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if func.overloadpacket.__name__ in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self._track(t)
        return out


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def _rows(t, mesh):
    return shlib.local_shard(t, shlib.input_spec(tuple(t.shape), mesh), mesh)


def build(cfg: ModelConfig, shape_cfg: ShapeConfig, mesh, *,
          moe_impl: str = "baseline", remat: str = "full",
          expert_mode: str = "ep", fsdp: bool = False,
          moments: str = "float32", seq_parallel: bool = False):
    """(program, args, on_block): ``program(*args)`` runs one rank's pass
    on meta tensors and returns its outputs; ``args`` are the rank's
    arguments.  Raises where the JAX dry run fails."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    if moe_impl == "m2n2d" and cfg.moe is not None:
        check_m2n2d(cfg, mesh)
    extras = stubs.extra_input_specs(cfg, B, DTYPE)
    keys = tuple(extras)
    dt = data_axes(mesh)
    if shape_cfg.kind == "train":
        # JAX's train record: its moments under zero_extend, but for the
        # default flags' layout, whose records stay as they were
        default = (expert_mode, fsdp, moe_impl, seq_parallel) == ("ep", False,
                                                                  "baseline", False)
        step = make_train_step(cfg, AdamWConfig(moment_dtype=moments), remat=remat,
                               extras_keys=keys, mesh=mesh, expert_mode=expert_mode,
                               fsdp=fsdp, zero=not default, moe_impl=moe_impl,
                               seq_parallel=seq_parallel)
        lay = step.layout
        params = lay.place_tree(init_params(cfg, dtype=DTYPE, device=META))
        for p in leaves(params):
            p.requires_grad_(True)
        opt = lay.init_opt_state(params, getattr(torch, moments))
        tokens = torch.empty((B, S + 1), dtype=torch.int32, device=META)
        on_block = [lf.path for lf in lay.leaves if lf.held == "owner"]

        def program(params, opt, tokens, *ex):
            return step(params, opt, tokens, *ex)

        return program, (params, opt, tokens, *(extras[k] for k in keys)), on_block

    held, assemble, on_block = place_params(cfg, mesh, expert_mode=expert_mode,
                                            fsdp=fsdp, moe_impl=moe_impl)

    def ctx(sp=False):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        stack.enter_context(parallel.ModelParallel(mesh, batch=B,
                                                   seq_parallel=sp).install())
        if moe_impl in ("m2n", "m2n2d"):
            stack.enter_context(m2n.use_m2n(mesh=mesh, data_axes=dt,
                                            expert_axis="model",
                                            weights_2d=moe_impl == "m2n2d"))
        return stack

    local_extras = {k: _rows(v, mesh) for k, v in extras.items()}
    if shape_cfg.kind == "prefill":
        tokens = _rows(torch.empty((B, S), dtype=torch.int32, device=META), mesh)

        def program(held, tokens, *ex):
            with ctx(seq_parallel):
                return prefill(assemble(held), cfg, tokens, max_seq=S,
                               **dict(zip(keys, ex)))

        return program, (held, tokens, *(local_extras[k] for k in keys)), on_block

    # decode: ONE new token against a seq_len cache in the rank's layout
    tokens = _rows(torch.empty((B,), dtype=torch.int32, device=META), mesh)
    pos = _rows(torch.empty((B,), dtype=torch.int32, device=META), mesh)
    cache = stubs.cache_specs(cfg, B, S, DTYPE, mesh=mesh)

    def program(held, tokens, cache, pos):
        with ctx():
            return decode_step(assemble(held), cfg, tokens, cache, pos,
                               capacity_mode="full")

    return program, (held, tokens, cache, pos), on_block


def _mv_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


# matrix products ``FlopCounterMode`` does not count by itself
FLOPS_EXTRA = {torch.ops.aten.mv: _mv_flops}


def measure(program, args, mesh):
    """Run ``program(*args)`` under the counters: (cost dict, memory dict,
    collective bytes by kind, by axes)."""
    mesh.reset()
    counter = OpCounter(args)
    with FlopCounterMode(display=False, custom_mapping=FLOPS_EXTRA) as flops, counter:
        out = program(*args)
    cost = {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(counter.bytes),
            "transcendentals": float(counter.transcendentals)}
    mem = {"argument_size": _tree_bytes(args), "output_size": _tree_bytes(out),
           "temp_size": counter.peak, "generated_code_size": None}
    del out
    return cost, mem, mesh.bytes_by_kind(), mesh.bytes_by_axes()


def _tag(arch, shape, multi_pod, moe_impl, remat, expert_mode, fsdp,
         seq_parallel, ssd_chunk):
    return (f"{arch}_{shape}_{'multi' if multi_pod else 'single'}"
            f"_{moe_impl}_{remat}"
            + (f"_{expert_mode}" if expert_mode != "ep" else "")
            + ("_fsdp" if fsdp else "")
            + ("_seqpar" if seq_parallel else "")
            + (f"_chunk{ssd_chunk}" if ssd_chunk else ""))


def run_one(arch: str, shape: str, multi_pod: bool, *, moe_impl="baseline",
            remat="full", out_dir=None, verbose=True, expert_mode="ep",
            fsdp=False, moments="float32", seq_parallel=False, ssd_chunk=0,
            coords=None, tag_extra=""):
    """One record: run the rank's program at ``coords`` (rank 0 by
    default) of the production grid and write it under ``out_dir``."""
    mesh_name = MESH_NAMES[multi_pod]
    mesh = RecordingMesh.named(mesh_name, coords)
    n_chips = 512 if multi_pod else 256
    cfg0 = get_config(arch)
    shape_cfg = INPUT_SHAPES[shape]
    base = {"arch": arch, "shape": shape, "mesh": mesh_name}
    if not shape_eligible(cfg0, shape):
        rec = dict(base, status="skipped", note=cfg0.long_context_note)
    else:
        cfg = effective_config(cfg0, shape, ssd_chunk=ssd_chunk)
        why = unsupported_reason(cfg, shape_cfg, mesh, moe_impl=moe_impl,
                                 expert_mode=expert_mode, fsdp=fsdp,
                                 seq_parallel=seq_parallel)
        if why is not None:
            rec = dict(base, status="unsupported", note=why, moe_impl=moe_impl,
                       remat=remat, expert_mode=expert_mode, fsdp=fsdp)
        else:
            rec = _run(cfg, shape_cfg, mesh, base, n_chips, moe_impl=moe_impl,
                       remat=remat, expert_mode=expert_mode, fsdp=fsdp,
                       moments=moments, seq_parallel=seq_parallel, verbose=verbose)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = _tag(arch, shape, multi_pod, moe_impl, remat, expert_mode, fsdp,
                   seq_parallel, ssd_chunk) + tag_extra
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _run(cfg, shape_cfg, mesh, base, n_chips, *, moe_impl, remat, expert_mode,
         fsdp, moments, seq_parallel, verbose):
    t0 = time.perf_counter()
    program, args, on_block = build(cfg, shape_cfg, mesh, moe_impl=moe_impl,
                                    remat=remat, expert_mode=expert_mode,
                                    fsdp=fsdp, moments=moments,
                                    seq_parallel=seq_parallel)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    cost, mem, coll, by_axes = measure(program, args, mesh)
    t_run = time.perf_counter() - t0
    model_fl = rl.model_flops_estimate(cfg, shape_cfg, n_chips)
    roof = rl.analyze(base["arch"], base["shape"], base["mesh"], n_chips, cost,
                      coll, model_fl, per_device_mem=mem["temp_size"])
    rec = dict(base, status="ok", moe_impl=moe_impl, remat=remat,
               expert_mode=expert_mode, fsdp=fsdp, t_lower_s=t_lower,
               t_compile_s=t_run, memory_analysis=mem, cost_analysis=cost,
               roofline=roof.to_dict(), hlo_bytes=None,
               collectives_by_axes=by_axes, coords=dict(mesh.coords),
               fsdp_block_dim=on_block)
    if verbose:
        print(f"[{base['arch']} x {base['shape']} x {base['mesh']}] place "
              f"{t_lower:.1f}s run {t_run:.1f}s  bottleneck={roof.bottleneck} "
              f"Tc/Tm/Tcoll(ms)={roof.t_compute*1e3:.2f}/"
              f"{roof.t_memory*1e3:.2f}/{roof.t_collective*1e3:.2f} "
              f"useful={roof.useful_flops_ratio:.2f}", flush=True)
        print(f"  memory: {mem}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--moe-impl", default="baseline",
                    choices=["baseline", "m2n", "m2n2d"])
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--expert-shard", default="ep", choices=["ep", "ep2d"])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--moments", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--save-hlo", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--no-unroll", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.save_hlo or args.no_unroll:
        ap.error("--save-hlo and --no-unroll have no meaning in the port: it "
                 "compiles no HLO and runs every layer of the rank's program")

    archs = ASSIGNED + PAPER if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    results = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_one(arch, shape, mp, moe_impl=args.moe_impl,
                                  remat=args.remat, out_dir=args.out,
                                  expert_mode=args.expert_shard, fsdp=args.fsdp,
                                  moments=args.moments,
                                  seq_parallel=args.seq_parallel,
                                  ssd_chunk=args.ssd_chunk)
                except Exception as e:  # noqa: BLE001 - recorded, then exit 1
                    rec = {"arch": arch, "shape": shape, "mesh": MESH_NAMES[mp],
                           "status": "FAILED", "error": repr(e)[:500]}
                    print(f"[{arch} x {shape}] FAILED: {e}", flush=True)
                results.append(rec)
    count = lambda s: sum(r["status"] == s for r in results)
    print(f"\ndry-run complete in {time.perf_counter() - t0:.1f}s: {count('ok')} ok, "
          f"{count('skipped')} skipped, {count('unsupported')} unsupported, "
          f"{count('FAILED')} failed")
    if count("FAILED"):
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
