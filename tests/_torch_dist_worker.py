"""Rank-side code of the port's multi-process tests, run as one process
per rank through ``repro_torch.launch.dist_smoke.run_ranks``:

  python tests/_torch_dist_worker.py m2n OUT_DIR
  python tests/_torch_dist_worker.py dp IN.pkl OUT_DIR
  python tests/_torch_dist_worker.py train OUT_DIR ARGS_JSON
  python tests/_torch_dist_worker.py shard OUT_DIR
  python tests/_torch_dist_worker.py grid IN.pkl OUT_DIR
  python tests/_torch_dist_worker.py layouts IN.pkl OUT_DIR
  python tests/_torch_dist_worker.py collectives OUT_DIR
  python tests/_torch_dist_worker.py serve IN.pkl OUT_DIR
  python tests/_torch_dist_worker.py disagg IN.pkl OUT_DIR

Every rank brings up ``MultiControllerTransport`` on the CPU (gloo) from
the ``REPRO_*`` variables, turns the warning ``torch.distributed`` gives
for a collective on a group without the calling rank into an error, and
writes what it computed under OUT_DIR.  ``M2N_CASES`` and ``m2n_case``
are shared with the JAX reference run of ``test_torch_distributed.py``.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import warnings

import numpy as np

# (name, grid shape over ("data", "model"), data axes, experts, weights_2d,
#  capacity mode): 6 experts on 2 shards with 2 data ranks (local
#  capacity in "train" mode), the same with d_ff split over the data
#  ranks, 5 experts padded to 6 buckets under weights_2d, and the JAX
#  package's 6 experts padded to 8 buckets over 4 shards
M2N_CASES = [
    ("2x2", (2, 2), ("data",), 6, False, "train"),
    ("2x2-2d", (2, 2), ("data",), 6, True, "train"),
    ("2x2-2d-pad", (2, 2), ("data",), 5, True, "full"),
    ("1x4-pad", (1, 4), ("data",), 6, False, "full"),
]
M2N_D, M2N_F, M2N_T, M2N_K = 8, 16, 32, 2


def m2n_case(E: int, seed: int = 0):
    """Router (with a bias toward the low experts, so that a capacity
    drops entries), expert weights and (T, d) tokens, f32 numpy."""
    rng = np.random.RandomState(seed)
    d, f = M2N_D, M2N_F
    p = {"router": rng.randn(d, E), "router_bias": np.linspace(1.5, -1.5, E),
         "we1": rng.randn(E, d, f) * 0.2, "we3": rng.randn(E, d, f) * 0.2,
         "we2": rng.randn(E, f, d) * 0.2}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rng.randn(M2N_T, d).astype(np.float32)


def _bring_up():
    import torch

    from repro_torch.core.transport import MultiControllerTransport
    torch.set_num_threads(1)
    warnings.filterwarnings("error", message=".*does not belong to the given group")
    return MultiControllerTransport(device="cpu")


def run_m2n(out_dir: str):
    import torch

    from repro_torch.config import MoEConfig
    from repro_torch.core.m2n import expert_shard, sharded_routed_experts
    from repro_torch.launch.mesh import make_mesh

    tr = _bring_up()
    meshes = {}
    for _, shape, *_ in M2N_CASES:           # every rank, in one order
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
    # the grid is row-major; a group of both axes spans every rank
    rank, grid = tr.process_index, meshes[(2, 2)]
    assert (grid.index("data"), grid.index("model")) == divmod(rank, 2)
    assert grid.index(("model", "data")) == rank
    assert int(grid.all_reduce(torch.ones(()), ("data", "model"))) == 4
    out = {}
    for name, shape, dax, E, w2d, mode in M2N_CASES:
        mesh = meshes[shape]
        p, x = m2n_case(E)
        cfg = MoEConfig(n_experts=E, top_k=M2N_K, d_ff_expert=M2N_F)
        n_data, i = mesh.size(dax), mesh.index(dax)
        t = M2N_T // n_data
        w = expert_shard({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                         mesh.size("model"), mesh.index("model"),
                         n_data=n_data if w2d else 1, i=i if w2d else 0)
        y, aux, counts = sharded_routed_experts(
            w, torch.from_numpy(x[i * t:(i + 1) * t]), cfg, "silu", mode,
            mesh=mesh, data_axes=dax, expert_axis="model", weights_2d=w2d,
            with_aux=True, with_counts=True, transport=tr)
        out.update({f"{name}/y": y.numpy(), f"{name}/aux": aux.numpy(),
                    f"{name}/counts": counts.numpy(), f"{name}/rows": np.array(i)})
    np.savez(os.path.join(out_dir, f"rank{tr.process_index}.npz"), **out)


def run_dp(in_path: str, out_dir: str):
    import torch

    from repro_torch.bridge import params_from_jax
    from repro_torch.config import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import loop
    from repro_torch.training.data_parallel import check_replicated
    from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                                leaves, named_leaves)

    tr = _bring_up()
    group = make_mesh((tr.process_count, 1), ("data", "model"),
                      device="cpu").group("data")
    with open(in_path, "rb") as fh:
        cases = pickle.load(fh)
    results = {}
    update = loop.adamw_update
    for case in cases:
        cfg = reduced(get_config(case["arch"]))
        params = params_from_jax(case["params"], cfg, device="cpu")
        for p in leaves(params):
            p.requires_grad_(True)
        toks = torch.from_numpy(case["tokens"])
        check_replicated(leaves(params) + [toks], group, "params and batches")
        grads = []

        def keep(opt_cfg, params, g, state, **kw):
            if not grads:
                grads.append([t.detach().clone().numpy() for t in g])
            return update(opt_cfg, params, g, state, **kw)

        loop.adamw_update = keep
        step = loop.make_train_step(cfg, AdamWConfig(**case["opt"]),
                                    remat=case["remat"], group=group)
        state = init_opt_state(params)
        metrics = []
        for s in range(toks.shape[0]):
            params, state, m = step(params, state, toks[s])
            metrics.append({k: float(v) for k, v in m.items()})
        loop.adamw_update = update
        check_replicated(leaves(params), group, "params after the steps")
        names = [k for k, _ in named_leaves(params)]
        results[case["name"]] = {
            "metrics": metrics, "grads": dict(zip(names, grads[0])),
            "params": {k: p.detach().numpy() for k, p in named_leaves(params)}}
    if tr.process_index == 0:
        with open(os.path.join(out_dir, "dp.pkl"), "wb") as fh:
            pickle.dump(results, fh)


def keep_step0(loop, out: dict):
    """Wrap ``loop.adamw_update`` so that its first call leaves in ``out``
    the step's gradients (before the update, which uses them as
    scratch), the params after it (this rank's blocks of each leaf, in
    ``named_leaves``' order) and the step's grad norm.  Returns the
    original, to put back."""
    import torch

    from repro_torch.training.optimizer import leaves

    update = loop.adamw_update
    host = lambda t: t.detach().to("cpu", copy=True).float().numpy()

    def keeping(cfg, params, grads, state, **kw):
        first = not out
        if first:
            out["grads"] = [host(g) for g in leaves(grads)]
        res = update(cfg, params, grads, state, **kw)
        if first:
            out["params"] = [host(p) for p in leaves(params)]
            out["grad_norm"] = float(torch.as_tensor(res[2]["grad_norm"]))
        return res

    loop.adamw_update = keeping
    return update


def run_train(out_dir: str, args_json: str):
    """``launch.train.run`` on this rank; saves its losses and, from step
    0, its blocks of the gradients and of the updated params
    (``keep_step0``)."""
    from repro_torch.launch.train import run
    from repro_torch.training import loop

    tr = _bring_up()
    step0 = {}
    update = keep_step0(loop, step0)
    try:
        losses = run(**json.loads(args_json))
    finally:
        loop.adamw_update = update
    rank = tr.process_index
    np.save(os.path.join(out_dir, f"losses{rank}.npy"), np.array(losses))
    with open(os.path.join(out_dir, f"step0_{rank}.pkl"), "wb") as fh:
        pickle.dump(step0, fh)


def grid_config(case):
    """The port's config of a ``grid`` case: the reduced ``arch`` (with
    ``n_heads`` query heads and ``n_layers`` layers where the case sets
    them) with the case's MoE overrides (``moe``)."""
    import dataclasses

    from repro_torch.config import get_config, reduced
    over = {k: case[k] for k in ("n_heads", "n_layers") if case.get(k)}
    cfg = reduced(get_config(case["arch"]), **over)
    if case.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **case["moe"]))
    return cfg


def run_grid(in_path: str, out_dir: str):
    """Grid training: for each case of IN.pkl (all on one grid shape),
    this rank's blocks of the JAX params (``bridge.shards_from_jax``):
    their ``forward_train`` logits under ``ModelParallel`` (the
    vocabulary-parallel LM head, gathered) within 1e-5 of one process's,
    then ``len(tokens)`` steps with ``make_train_step(mesh=...)``.
    Saves per rank the metrics, the step-0 gradients of the leaves the
    rules leave whole over "model" (to be equal on every model rank), and
    on rank 0 the gathered step-0 gradients and final params; every rank
    gathers the grid's checkpoint (rank 0 writes it under OUT_DIR/ck-NAME)
    and restores the case's one-process checkpoint (``ckpt`` in IN.pkl)
    into its blocks.  ``extras`` (numpy, the global batch's frames /
    patches) go to the passes as the stub inputs.  A case with
    ``against_one`` holds no JAX reference: its steps on the rank's
    blocks of ``init_params(cfg, 0)`` and one process's steps on the
    whole params, both in the rank, save their losses."""
    import torch

    from repro_torch.bridge import params_from_jax, shards_from_jax
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import ModelParallel
    from repro_torch.models.transformer import forward_train, init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import loop
    from repro_torch.training.data_parallel import check_replicated
    from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                                leaves, named_leaves)

    tr = _bring_up()
    with open(in_path, "rb") as fh:
        cases = pickle.load(fh)
    mesh = make_mesh(cases[0]["grid"], ("data", "model"), device="cpu")
    rank, results = tr.process_index, {}
    update = loop.adamw_update
    for case in cases:
        cfg = grid_config(case)
        opt = AdamWConfig(**case["opt"])
        toks = torch.from_numpy(case["tokens"])
        extras = {k: torch.from_numpy(v) for k, v in case.get("extras", {}).items()}
        if case.get("against_one"):
            one = _steps(cfg, opt, init_params(cfg, 0, device="cpu"), toks, extras)
            full = init_params(cfg, 0, device="cpu")      # a draw of its own
            local = sh.shard_tree(full, sh.param_specs(cfg, full, mesh), mesh)
            results[case["name"]] = {
                "losses": [one, _steps(cfg, opt, local, toks, extras, mesh=mesh)]}
            continue
        params = shards_from_jax(case["params"], cfg, mesh, device="cpu")
        with torch.no_grad():           # the gathered vocabulary-parallel logits
            want = forward_train(params_from_jax(case["params"], cfg, device="cpu"),
                                 cfg, toks[0, :, :-1], remat="none", **extras)[0]
            with ModelParallel(mesh).install():
                got = forward_train(params, cfg, toks[0, :, :-1], remat="none",
                                    **extras)[0]
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), \
            f"{case['name']}: logits off by {float((got - want).abs().max())}"
        for p in leaves(params):
            p.requires_grad_(True)
        specs = sh.param_specs(cfg, init_params(cfg, device="meta"), mesh)
        flat_specs = [s for _, s in sh.named_specs(specs)]
        check_replicated([toks], mesh.group("model"), "batches")
        grads = []

        def keep(opt_cfg, params, g, state, **kw):
            if not grads:
                grads.append([t.detach().clone() for t in g])
            return update(opt_cfg, params, g, state, **kw)

        loop.adamw_update = keep
        step = loop.make_train_step(cfg, opt, remat=case["remat"], mesh=mesh,
                                    extras_keys=tuple(extras))
        state = init_opt_state(params)
        metrics = []
        for s in range(toks.shape[0]):
            params, state, m = step(params, state, toks[s], *extras.values())
            metrics.append({k: float(v) for k, v in m.items()})
        loop.adamw_update = update
        names = [k for k, _ in named_leaves(params)]
        whole = {k: g.numpy() for k, g, sp in zip(names, grads[0], flat_specs)
                 if "model" not in sp.axes()}
        full_g = [sh.gather_full(g, sp, mesh) for g, sp in zip(grads[0], flat_specs)]
        full_p = dict(named_leaves(sh.gather_tree(params, specs, mesh)))
        d = os.path.join(out_dir, f"ck-{case['name']}")
        ckpt.save(d, toks.shape[0], params, state, mesh=mesh, specs=specs)
        tmpl = init_opt_state(params)
        back, back_opt, _ = ckpt.restore(case["ckpt"], params, tmpl, mesh=mesh,
                                         specs=specs)
        want = shards_from_jax(case["params"], cfg, mesh, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(want))), \
            f"{case['name']}: the one-process checkpoint restored other blocks"
        assert all(float(t.abs().sum()) == 0 for t in leaves(back_opt.mu)), \
            f"{case['name']}: the one-process checkpoint's moments"
        results[case["name"]] = {"metrics": metrics, "whole_grads": whole}
        if rank == 0:
            results[case["name"]].update(
                grads={k: g.numpy() for k, g in zip(names, full_g)},
                params={k: p.detach().numpy() for k, p in full_p.items()})
    with open(os.path.join(out_dir, f"grid{rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)


def run_layouts(in_path: str, out_dir: str):
    """The JAX dry run's training layouts (``make_train_step(mesh=...,
    expert_mode=, fsdp=, zero=, moe_impl=, seq_parallel=)``): for each
    case of IN.pkl, this rank's blocks of the JAX params under the
    layout (``Layout.place_tree``), ``len(tokens)`` steps; saves the
    metrics, step 0's gradient blocks as AdamW sees them, the params
    after step 0 and at the end (the rank's held blocks, by path), or
    the layout's refusal.  A case with ``prefill`` also runs a
    sequence-parallel prefill of the first batch's rows on the initial
    params (the "ep" blocks) and the same prefill without the flag:
    the logits of both and the gathered caches' largest gap."""
    import torch

    from repro_torch.bridge import params_from_jax, shards_from_jax
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import ModelParallel
    from repro_torch.models.transformer import prefill
    from repro_torch.training import data_parallel as dp
    from repro_torch.training import loop
    from repro_torch.training.optimizer import AdamWConfig, leaves, named_leaves

    tr = _bring_up()
    with open(in_path, "rb") as fh:
        cases = pickle.load(fh)
    mesh = make_mesh(cases[0]["grid"], ("data", "model"), device="cpu")
    rank, results = tr.process_index, {}
    update = loop.adamw_update
    host = lambda t: t.detach().to("cpu", copy=True).numpy()
    for case in cases:
        cfg = grid_config(case)
        opt = AdamWConfig(**case["opt"])
        toks = torch.from_numpy(case["tokens"])
        res = results[case["name"]] = {}
        if case.get("prefill"):
            ep = shards_from_jax(case["params"], cfg, mesh, device="cpu")
            rows = dp.local_rows(toks[0, :, :-1], mesh.group(("data",)))
            out = []
            for spf in (True, False):
                with torch.no_grad(), ModelParallel(mesh, seq_parallel=spf).install():
                    logits, cache = prefill(ep, cfg, rows, max_seq=rows.shape[1])
                out.append((logits, cache))
            res["prefill"] = [host(o[0]) for o in out]
            res["prefill_cache_gap"] = max(
                float((a - b).abs().max()) for a, b in zip(leaves(out[0][1]),
                                                           leaves(out[1][1])))
        try:
            step = loop.make_train_step(cfg, opt, remat=case["remat"], mesh=mesh,
                                        **case["layout"])
        except sh.DuplicateSpecError as e:
            res["refused"] = f"{type(e).__name__}: {e}"
            continue
        lay = step.layout
        params = lay.place_tree(params_from_jax(case["params"], cfg, device="cpu"))
        for p in leaves(params):
            p.requires_grad_(True)
        state = lay.init_opt_state(params)
        kept = {}

        def keep(opt_cfg, ps, g, st, **kw):
            if not kept:
                kept["grads"] = [host(t) for t in g]
                kept["gnorm"] = float(kw["gnorm"]) if kw.get("gnorm") is not None \
                    else None
            return update(opt_cfg, ps, g, st, **kw)

        loop.adamw_update = keep
        metrics = []
        try:
            for s in range(toks.shape[0]):
                params, state, m = step(params, state, toks[s])
                metrics.append({k: float(v) for k, v in m.items()})
                if s == 0:
                    res["after0"] = {k: host(v) for k, v in named_leaves(params)}
        finally:
            loop.adamw_update = update
        names = [k for k, _ in named_leaves(params)]
        res.update(metrics=metrics, grads=dict(zip(names, kept["grads"])),
                   final={k: host(v) for k, v in named_leaves(params)})
    with open(os.path.join(out_dir, f"layouts{rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)


def run_collectives(out_dir: str):
    """``ProcessMesh.all_gather`` / ``reduce_scatter`` and the autograd
    collectives of ``models.parallel`` on a (2, 2) grid, with the inputs
    ``tests/test_torch_grid_layouts.py`` recomputes in numpy (each rank's
    from its own seeds); saves each output and gradient."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import parallel

    tr = _bring_up()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rank = tr.process_index
    i = mesh.index("data")
    arr = lambda seed, shape: torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))
    x = arr(100 + rank, (2, 3, 4))
    axes = {"data": "data", "model": "model", "both": ("data", "model")}
    out = {}
    for name, ax in axes.items():
        n = mesh.size(ax)
        for dim in range(3):
            out[f"all_gather/{name}/{dim}"] = mesh.all_gather(x, ax, dim).numpy()
            out[f"reduce_scatter/{name}/{dim}"] = mesh.reduce_scatter(
                torch.cat([x] * n, dim), ax, dim).numpy()
    T, rows = 5, 2
    b = -(-T // 2)
    j = mesh.index("model")
    lo, hi = min(T, j * b), min(T, (j + 1) * b)
    seq = arr(300 + rank, (rows, T, 4))
    mp = parallel.ModelParallel(mesh, seq_parallel=True)
    pairs = {
        "gather_data": (x, lambda t: parallel.gather_data(t, mesh, ("data",), 1)),
        "from_owner": (x if i == 1 else x.new_empty((0,)),
                       lambda t: parallel.from_owner(t, mesh, ("data",), 1, (2, 3, 4))),
        "sum_data": (x, lambda t: parallel.sum_data(t, mesh, ("data",))),
        "seq_full": (seq[:, lo:hi], mp.seq_full),
        "enter_seq": (seq[:, lo:hi], lambda t: mp.enter_seq(mp.seq_full(t))),
        "seq_block": (seq, mp.seq_block),
        "reduce_act": (seq, mp.reduce_act),
    }
    for name, (t, fn) in pairs.items():
        t = t.clone().requires_grad_(True)
        with mp.seq_region(rows, T):
            y = fn(t)
        (y * arr(200 + rank, tuple(y.shape))).sum().backward()
        out[f"{name}/out"] = y.detach().numpy()
        out[f"{name}/grad"] = t.grad.numpy()
    np.savez(os.path.join(out_dir, f"coll{rank}.npz"), **out)


def _steps(cfg, opt, params, toks, extras, mesh=None):
    """The losses of ``len(toks)`` train steps of ``params`` (the rank's
    blocks on ``mesh``, or whole in one process)."""
    from repro_torch.training import loop
    from repro_torch.training.optimizer import init_opt_state, leaves
    for p in leaves(params):
        p.requires_grad_(True)
    step = loop.make_train_step(cfg, opt, remat="none", mesh=mesh,
                                extras_keys=tuple(extras))
    state, losses = init_opt_state(params), []
    for t in toks:
        params, state, m = step(params, state, t, *extras.values())
        losses.append(float(m["loss"]))
    return losses


def run_serve(in_path: str, out_dir: str):
    """Serving on a grid: for each case of IN.pkl (all on one grid
    shape), this rank's blocks of the JAX params; its rows of the prompt
    through ``prefill`` and ``steps`` greedy ``decode_step``s under
    ``ModelParallel`` (with ``m2n`` also under ``core.m2n.use_m2n`` over
    "model", the kernel path of the expert shards).  Saves per rank each
    pass's logits, the greedy tokens and the final cache blocks.
    ``extras`` (numpy, the global batch's frames / patches) go to
    ``prefill``, the rank's rows of them.  A case with ``against_one``
    holds no JAX reference: the same passes on the rank's blocks of
    ``init_params(cfg, 0)`` and, in the rank, on the whole params in one
    process.  Rank 0 also keeps the cache gathered from every rank's
    blocks (``sharding.gather_cache``)."""
    import contextlib

    import torch

    from repro_torch.bridge import shards_from_jax
    from repro_torch.core.m2n import use_m2n
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.parallel import ModelParallel

    tr = _bring_up()
    with open(in_path, "rb") as fh:
        cases = pickle.load(fh)
    mesh = make_mesh(cases[0]["grid"], ("data", "model"), device="cpu")
    rank, results = tr.process_index, {}
    n_data, i = mesh.size("data"), mesh.index("data")
    for case in cases:
        cfg = grid_config(case)
        toks = torch.from_numpy(case["tokens"]).long()
        b = toks.shape[0] // n_data
        toks = toks[i * b:(i + 1) * b]
        extras = {k: torch.from_numpy(v[i * b:(i + 1) * b])
                  for k, v in case.get("extras", {}).items()}
        if case.get("against_one"):
            full = tf.init_params(cfg, 0, device="cpu")
            local = sh.shard_tree(full, sh.param_specs(cfg, full, mesh), mesh)
            with torch.no_grad():
                one = _serve(tf, cfg, full, toks, extras, case)
                with ModelParallel(mesh).install():
                    got = _serve(tf, cfg, local, toks, extras, case)
            results[case["name"]] = {"one": one[:2], "grid": got[:2]}
            continue
        params = shards_from_jax(case["params"], cfg, mesh, device="cpu")
        m2n = (use_m2n(mesh=mesh, expert_axis="model") if case.get("m2n")
               else contextlib.nullcontext())
        with torch.no_grad(), ModelParallel(mesh).install(), m2n:
            logits, tokens, cache = _serve(tf, cfg, params, toks, extras, case)
        whole = sh.gather_cache(cache, cfg, mesh, b * n_data, case["max_seq"])
        results[case["name"]] = {
            "logits": logits, "tokens": tokens, "rows": (i * b, (i + 1) * b),
            "cache": [{k: t.numpy() for k, t in e.items()} for e in cache]}
        if rank == 0:
            results[case["name"]]["gathered"] = [
                {k: t.numpy() for k, t in e.items()} for e in whole]
    with open(os.path.join(out_dir, f"serve{rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)


def _serve(tf, cfg, params, toks, extras, case):
    """``prefill`` of ``toks`` then ``case["steps"]`` greedy
    ``decode_step``s under whatever is installed: (each pass's logits,
    the greedy tokens, the final cache)."""
    import torch
    b = toks.shape[0]
    logits, tokens = [], []
    lg, cache = tf.prefill(params, cfg, toks, max_seq=case["max_seq"], **extras)
    logits.append(lg.numpy())
    tok = lg.argmax(-1)
    for s in range(case["steps"]):
        tokens.append(tok.numpy())
        pos = torch.full((b,), toks.shape[1] + s, dtype=torch.int32)
        lg, cache = tf.decode_step(params, cfg, tok, cache, pos)
        logits.append(lg.numpy())
        tok = lg.argmax(-1)
    tokens.append(tok.numpy())
    return logits, tokens, cache


def run_shard(out_dir: str):
    """``local_shard`` / ``gather_full`` on 4 ranks: hand-made specs on a
    (2, 2) grid (either axis, both on one dim, one per dim, the data
    axes of a 3-axis grid), then reduced mixtral's and gemma2's params
    under the ep, ep2d and fsdp rules of a (2, 2) and a (1, 4) grid, each
    gathered back to the tensor it came from."""
    import torch

    from repro_torch.config import get_config, reduced
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import leaves

    tr = _bring_up()
    grids = {(2, 2): make_mesh((2, 2), ("data", "model"), device="cpu"),
             (1, 4): make_mesh((1, 4), ("data", "model"), device="cpu"),
             (2, 1, 2): make_mesh((2, 1, 2), ("pod", "data", "model"),
                                  device="cpu")}
    mesh = grids[2, 2]
    full = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    got = {}
    for name, spec in (("both", sh.Spec(("data", "model"), None)),
                       ("model_cols", sh.Spec(None, "model")),
                       ("data_rows", sh.Spec("data", None)),
                       ("one_each", sh.Spec("model", "data"))):
        block = sh.local_shard(full, spec, mesh)
        got[name] = block.numpy()
        assert torch.equal(sh.gather_full(block, spec, mesh), full), name
    spec = sh.Spec(("pod", "data"), "model")
    assert torch.equal(sh.gather_full(sh.local_shard(full, spec, grids[2, 1, 2]),
                                      spec, grids[2, 1, 2]), full)
    bf = full.to(torch.bfloat16)
    assert torch.equal(sh.gather_full(sh.local_shard(bf, sh.Spec("model", None),
                                                     mesh),
                                      sh.Spec("model", None), mesh), bf)
    for arch in ("mixtral-8x22b", "gemma2-27b"):
        cfg = reduced(get_config(arch))
        params = init_params(cfg, 0, device="cpu")
        for shape in ((2, 2), (1, 4)):
            for mode, fsdp in (("ep", False), ("ep2d", False), ("ep", True)):
                specs = sh.param_specs(cfg, params, grids[shape], expert_mode=mode,
                                       fsdp=fsdp)
                local = sh.shard_tree(params, specs, grids[shape])
                back = sh.gather_tree(local, specs, grids[shape])
                for a, b in zip(leaves(params), leaves(back), strict=True):
                    assert torch.equal(a, b), (arch, shape, mode, fsdp)
                n_full = sum(t.numel() for t in leaves(params))
                n_local = sum(t.numel() for t in leaves(local))
                assert n_local < n_full, (arch, shape, mode, fsdp)
    np.savez(os.path.join(out_dir, f"shard{tr.process_index}.npz"), **got)


def run_disagg(in_path: str, out_dir: str):
    """The disaggregated runtime on this world's ranks: for each case of
    IN.pkl its layout (``ServingRoles`` of the case's prefill count, or
    the pinned ``attn_ranks`` / ``expert_ranks``), brought up by
    ``setup_serving``, and reduced mixtral from the JAX params (numpy,
    with the zipf router bias where set), of which the rank keeps its
    role's leaves (``arch``: another reduced config).  ``step``: a
    prefill and one ``decode_step`` of the
    runtime (m = 2), the logits of the rank's rows; ``engine``: the
    serving engine of ``launch.serve.engine_for`` over ``prompts``, its
    tokens and merged stats; ``serve``: ``launch.serve.run`` with
    ``transport="multi"`` (its own draw from the seed), the engine's
    tokens and stats; ``refuse``: the error the layout raises.  Saves
    per rank."""
    import torch

    from repro_torch.bridge import params_from_jax
    from repro_torch.config import get_config, reduced
    from repro_torch.core.disagg import (DisaggPlan, DisaggregatedInstance,
                                         rank_params)
    from repro_torch.core.pingpong import even_partition
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import ServingRoles
    from repro_torch.models.transformer import prefill
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import Request

    tr = _bring_up()
    with open(in_path, "rb") as fh:
        cases = pickle.load(fh)
    rank, out = tr.process_index, {}
    for case in cases:
        cfg = reduced(get_config(case.get("arch", "mixtral-8x22b")))
        P = case.get("prefill", 0)
        roles = ServingRoles(tr.process_count, P,
                             attn_ranks=case.get("attn_ranks"),
                             expert_ranks=case.get("expert_ranks"))
        tr.setup_serving(roles)
        tr.reset_stats()
        res = {"role": roles.role(rank)}
        if case["kind"] == "serve":
            engines = []
            build = serve.build

            def keep(sc):
                c, eng = build(sc)
                engines.append(eng)
                return c, eng

            serve.build = keep
            try:
                st = serve.run(**case["run"])
            finally:
                serve.build = build
            res.update(tokens={r.rid: list(r.generated) for r in engines[0].finished},
                       stats=st)
            out[case["name"]] = res
            continue
        full = params_from_jax(case["params"], cfg, device="cpu")
        if case.get("zipf"):
            serve.inject_router_bias(full, cfg, serve.zipf_router_bias(
                cfg.moe.n_experts, case["zipf"]))
        try:
            params = rank_params(cfg, full, roles, rank, use_m2n=case.get("m2n", False),
                                 inline_prefill=not P)
            plan = DisaggPlan(n_microbatches=case.get("m", 2),
                              use_m2n=case.get("m2n", False))
            if case["kind"] == "refuse":
                DisaggregatedInstance(cfg, params, plan=plan, transport=tr)
        except ValueError as e:
            res["error"] = f"{type(e).__name__}: {e}"
            out[case["name"]] = res
            continue
        if case["kind"] == "step":
            inst = DisaggregatedInstance(cfg, params, plan=plan, transport=tr)
            toks = torch.from_numpy(case["tokens"]).long()
            B = toks.shape[0]
            rows = inst.attn_rows(even_partition(B, plan.n_microbatches))
            cache = nxt = None
            if rows is not None:
                last, whole = prefill(params, cfg, toks, max_seq=case["max_seq"])
                nxt = last.argmax(-1)
                cache = [{k: t[rows].clone() for k, t in e.items()} for e in whole]
            nxt = tr.share(torch.zeros(B, dtype=torch.int64) if nxt is None else
                           nxt * (rank == roles.attn[0]))
            pos = torch.full((B,), toks.shape[1], dtype=torch.int32)
            with torch.no_grad():
                logits, _ = inst.decode_step(nxt, cache, pos)
            res.update(rows=None if rows is None else (rows.start, rows.stop),
                       nxt=nxt.numpy(),
                       logits=None if logits is None else logits.numpy(),
                       stages=inst.stage_report())
        else:
            sc = ServingConfig(device="cpu", runtime="pingpong",
                               microbatches=case.get("m", 2),
                               use_m2n=case.get("m2n", False),
                               max_batch=case["max_batch"], max_seq=case["max_seq"],
                               prefill_devices=P, transfer=case.get("transfer", "async"),
                               kv_layout=case.get("layout", "contiguous"),
                               page_size=case.get("page_size", 8),
                               expert_rebalance_every=case.get("rebalance", 0),
                               transport="multi", verbose=False)
            eng = serve.engine_for(sc, cfg, params, tr)
            for i, p in enumerate(case["prompts"]):
                eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=case["max_new"]))
            with torch.no_grad():
                done = eng.run_until_done()
            res.update(tokens={r.rid: list(r.generated) for r in done},
                       stats=eng.stats())
        out[case["name"]] = res
    with open(os.path.join(out_dir, f"disagg{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    mode, *rest = sys.argv[1:]
    {"m2n": run_m2n, "dp": run_dp, "train": run_train, "shard": run_shard,
     "grid": run_grid, "serve": run_serve, "disagg": run_disagg,
     "layouts": run_layouts, "collectives": run_collectives}[mode](*rest)
    import torch.distributed as dist
    dist.barrier()      # no rank tears its groups down while a peer still uses them
    dist.destroy_process_group()
    # leave without the interpreter's finalization: there the gloo groups'
    # leftover C++ objects abort a rank ("terminate called without an
    # active exception", no Python frame) a few runs in a hundred under
    # load, after its results are written
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
