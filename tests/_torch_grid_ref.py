"""The JAX side of ``tests/test_torch_model_axis.py``, run in a child
interpreter with 4 forced host devices (the dry-run flag must not reach
the test process, whose JAX sees one device):

  python tests/_torch_grid_ref.py IN.pkl OUT.pkl

For each reference of IN.pkl (arch, query heads where set, MoE
overrides, grid or None, the AdamW config, the token batches of the
steps, the stub inputs (``extras``: frames / patches) where the model
reads them, the JAX params as numpy) it runs the JAX train step, its
gradients kept: on a (data, model) grid
the JAX launcher's way (params placed by ``shlib.param_specs``, tokens
by ``shlib.input_spec``, GSPMD shards the step), or on one device.  It
writes per reference each step's loss and aux, step 0's gradients, the
final params, and the entries dropped past their expert's capacity in
each step (a forward pass over each step's params that counts them
with a ``jax.debug.callback`` in the routed experts).

A reference with a ``layout`` (``tests/test_torch_grid_layouts.py``) runs
the JAX dry run's build of a train record on its grid: params placed by
``param_specs(expert_mode=, fsdp=)``, the moments by the dry run's
``zero_extend`` with ``zero``, ``transformer.ACT_SPEC`` set with
``seq_parallel``, the step traced under ``m2n.use_m2n`` with ``moe_impl``
"m2n" / "m2n2d".  It also writes the params after step 0, the prefill
logits of the first batch with ``prefill``, and, where JAX refuses the
layout, only the error (``refused``).
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.core import m2n as jm2n  # noqa: E402
from repro.launch import sharding as shlib  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402


def config(ref):
    over = {k: ref[k] for k in ("n_heads", "n_layers") if ref.get(k)}
    cfg = jconfig.reduced(jconfig.get_config(ref["arch"]), **over)
    if ref.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **ref["moe"]))
    return cfg


def drops(cfg, params, tokens):
    """Entries past their expert's capacity in one forward pass."""
    seen = []

    def counting(p, x, mcfg, act, mode):
        r = jmoe.route(x, p["router"], mcfg.top_k, p.get("router_bias"))
        C = jmoe.expert_capacity(x.shape[0], mcfg, mode)
        counts = jax.nn.one_hot(r.experts, mcfg.n_experts).sum((0, 1))
        jax.debug.callback(
            lambda c: seen.append(float(np.maximum(np.asarray(c) - C, 0).sum())),
            counts)
        return jmoe.routed_experts_dense(p, x, mcfg, act, mode)

    prev = jmoe.set_routed_impl(counting)
    try:
        jax.block_until_ready(jax.jit(
            lambda p, t: jtf.forward_hidden(p, cfg, t, remat="none")[1])(
                params, jnp.asarray(tokens[:, :-1])))
        jax.effects_barrier()
    finally:
        jmoe.set_routed_impl(prev)
    return sum(seen)


def zero_extend(spec, shape, mesh):
    """The JAX dry run's ZeRO-1 rule (``repro.launch.dryrun``, whose import
    would set its own device count)."""
    dt = ("data",)
    n = mesh.shape["data"]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and dim % n == 0:
            parts[i] = dt
            return P(*parts)
    return P(*parts)


def run_layout(ref):
    """A train record's build of the JAX dry run on the reference's grid."""
    import contextlib
    cfg = config(ref)
    lay = ref["layout"]
    opt = jopt.AdamWConfig(**ref["opt"])
    n = ref["grid"][0] * ref["grid"][1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(ref["grid"]), ("data", "model"))
    params = jax.tree.map(jnp.asarray, ref["params"])
    pspecs = shlib.param_specs(cfg, params, mesh, expert_mode=lay.get("expert_mode", "ep"),
                               fsdp=lay.get("fsdp", False))
    state = jopt.init_opt_state(params)
    try:
        params = jax.device_put(params, shlib.to_shardings(mesh, pspecs))
        if lay.get("zero"):
            ospecs = jax.tree.map(lambda sp, st: zero_extend(sp, st.shape, mesh), pspecs,
                                  params, is_leaf=lambda x: isinstance(x, P))
            osh = shlib.to_shardings(mesh, ospecs)
            state = type(state)(state.step, jax.device_put(state.mu, osh),
                                jax.device_put(state.nu, osh))
    except Exception as e:  # noqa: BLE001 - JAX's refusal is the result
        return {"refused": f"{type(e).__name__}: {e}"}
    jtf.ACT_SPEC = P(("data",), "model", None) if lay.get("seq_parallel") else None
    impl = lay.get("moe_impl", "baseline")
    ctx = (jm2n.use_m2n(mesh, ("data",), "model", weights_2d=impl == "m2n2d")
           if impl != "baseline" else contextlib.nullcontext())

    def step(params, state, tokens):
        (_, (loss, aux)), grads = jax.value_and_grad(jloop.lm_loss, has_aux=True)(
            params, cfg, tokens, {}, "none")
        params, state, _ = jopt.adamw_update(opt, params, grads, state)
        return params, state, grads, loss, aux

    tok_sh = NamedSharding(mesh, shlib.input_spec(ref["tokens"].shape[1:], mesh))
    out = {"loss": [], "aux": []}
    try:
        with ctx, mesh:
            if ref.get("prefill"):      # the initial params' prefill
                x = jnp.asarray(ref["tokens"][0][:, :-1])
                logits, _ = jax.jit(lambda p, t: jtf.prefill(
                    p, cfg, t, max_seq=t.shape[1]))(params, jax.device_put(x, tok_sh))
                out["prefill"] = np.asarray(logits)
            fn = jax.jit(step)
            before = []
            for s, toks in enumerate(ref["tokens"]):
                before.append(jax.tree.map(np.asarray, params))
                params, state, grads, loss, aux = fn(
                    params, state, jax.device_put(jnp.asarray(toks), tok_sh))
                out["loss"].append(float(loss))
                out["aux"].append(float(aux))
                if s == 0:
                    out["grads"] = jax.tree.map(np.asarray, grads)
                    out["after0"] = jax.tree.map(np.asarray, params)
    finally:
        jtf.ACT_SPEC = None
    out["params"] = jax.tree.map(np.asarray, params)
    if cfg.moe is not None and impl == "baseline":
        out["drops"] = [drops(cfg, p, t) for p, t in zip(before, ref["tokens"])]
    return out


def run(ref):
    if ref.get("layout") is not None:
        return run_layout(ref)
    cfg = config(ref)
    opt = jopt.AdamWConfig(**ref["opt"])

    def step(params, state, tokens, extras):
        (_, (loss, aux)), grads = jax.value_and_grad(jloop.lm_loss, has_aux=True)(
            params, cfg, tokens, extras, "none")
        params, state, _ = jopt.adamw_update(opt, params, grads, state)
        return params, state, grads, loss, aux

    params = jax.tree.map(jnp.asarray, ref["params"])
    if ref["grid"] is None:
        mesh, fn = None, jax.jit(step)
        place = lambda t: jnp.asarray(t)
    else:
        n = ref["grid"][0] * ref["grid"][1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(ref["grid"]),
                    ("data", "model"))
        params = jax.device_put(params, shlib.to_shardings(
            mesh, shlib.param_specs(cfg, params, mesh)))
        fn = jax.jit(step)
        tok_sh = NamedSharding(mesh, shlib.input_spec(ref["tokens"].shape[1:], mesh))
        place = lambda t: jax.device_put(jnp.asarray(t), tok_sh)
    extras = {k: jnp.asarray(v) for k, v in ref.get("extras", {}).items()}
    if mesh is not None:
        extras = {k: jax.device_put(v, NamedSharding(
            mesh, shlib.input_spec(v.shape, mesh))) for k, v in extras.items()}
    state = jopt.init_opt_state(params)
    out = {"loss": [], "aux": [], "before": []}
    for toks in ref["tokens"]:
        out["before"].append(jax.tree.map(np.asarray, params))
        if mesh is not None:
            with mesh:
                params, state, grads, loss, aux = fn(params, state, place(toks),
                                                     extras)
        else:
            params, state, grads, loss, aux = fn(params, state, place(toks), extras)
        out["loss"].append(float(loss))
        out["aux"].append(float(aux))
        out.setdefault("grads", jax.tree.map(np.asarray, grads))
    out["params"] = jax.tree.map(np.asarray, params)
    out["drops"] = ([drops(cfg, p, t) for p, t in zip(out.pop("before"), ref["tokens"])]
                    if cfg.moe is not None else None)
    return out


if __name__ == "__main__":
    assert jax.device_count() == 4, jax.device_count()
    with open(sys.argv[1], "rb") as fh:
        refs = pickle.load(fh)
    with open(sys.argv[2], "wb") as fh:
        pickle.dump({r["key"]: run(r) for r in refs}, fh)
