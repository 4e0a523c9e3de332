"""The JAX side of ``tests/test_torch_model_axis_decode.py``, run in a
child interpreter with 4 forced host devices (the flag must not reach
the test process, whose JAX sees one device):

  python tests/_torch_serve_ref.py IN.pkl OUT.pkl

For each reference of IN.pkl (arch, query heads where set, grid, prompt
tokens, decode steps, max_seq, the stub inputs (``extras``: frames /
patches) where the model reads them, the JAX params as numpy) it runs the JAX ``prefill`` and then
greedy ``decode_step``s on a (data, model) grid the JAX dry run's way:
params placed by ``shlib.param_specs``, tokens and positions by
``shlib.input_spec``, the cache by ``shlib.cache_specs`` (GSPMD shards
both passes).  It writes per reference the prefill's last logits and
each step's logits, the greedy tokens, and the final cache (numpy).
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.launch import sharding as shlib  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402


def run(ref):
    cfg = jconfig.reduced(jconfig.get_config(ref["arch"]),
                          **({"n_heads": ref["n_heads"]} if ref.get("n_heads") else {}))
    n = ref["grid"][0] * ref["grid"][1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(ref["grid"]), ("data", "model"))
    toks = ref["tokens"]
    B, S = toks.shape[0], ref["max_seq"]
    params = jax.tree.map(jnp.asarray, ref["params"])
    params = jax.device_put(params, shlib.to_shardings(
        mesh, shlib.param_specs(cfg, params, mesh)))
    row = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, shlib.input_spec(a.shape, mesh)))
    cspecs = shlib.cache_specs(cfg, jstubs.cache_specs(cfg, B, S, jnp.float32),
                               mesh, B)
    csh = shlib.to_shardings(mesh, cspecs)
    extras = {k: row(v) for k, v in ref.get("extras", {}).items()}
    with mesh:
        logits, cache = jax.jit(lambda p, t, ex: jtf.prefill(p, cfg, t, max_seq=S,
                                                             **ex))(
            params, row(toks), extras)
        cache = jax.device_put(cache, csh)
        step = jax.jit(lambda p, t, c, q: jtf.decode_step(p, cfg, t, c, q,
                                                          capacity_mode="full"))
        out = {"logits": [np.asarray(logits)], "tokens": []}
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        for s in range(ref["steps"]):
            pos = np.full((B,), toks.shape[1] + s, np.int32)
            out["tokens"].append(tok)
            logits, cache = step(params, row(tok), cache, row(pos))
            out["logits"].append(np.asarray(logits))
            tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        out["tokens"].append(tok)
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


if __name__ == "__main__":
    assert jax.device_count() == 4, jax.device_count()
    with open(sys.argv[1], "rb") as fh:
        refs = pickle.load(fh)
    with open(sys.argv[2], "wb") as fh:
        pickle.dump({r["key"]: run(r) for r in refs}, fh)
