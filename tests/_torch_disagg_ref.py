"""The JAX side of ``tests/test_torch_disagg_ranks*.py``, run in a child
interpreter with 8 forced host devices (the flag must not reach the test
process, whose JAX sees one device):

  python tests/_torch_disagg_ref.py IN.pkl OUT.pkl

The JAX package's disaggregated runtime on disjoint device groups, as
``tests/test_multidevice.py`` runs it, on reduced mixtral (or the
case's ``arch``) from ``init_params(PRNGKey(0))``.  Each case of IN.pkl names its split
(``prefill`` / ``attn`` / ``expert`` device counts, taken from the front
of the device list: attention first, then experts, then prefill):

  * ``step``: the monolithic and the disaggregated ``decode_step`` (m =
    2) after a prefill of ``tokens``: both steps' logits;
  * ``engine``: the engine over ``prompts`` (``max_new`` tokens each) in
    one of the modes ``mono``, ``pingpong`` (``m2n``, ``rebalance``,
    ``zipf``, ``layout``) or ``worker`` (a ``PrefillWorker`` on the
    prefill devices, ``transfer``): the tokens and the stats the tests
    read;
  * ``refuse``: the instance on an expert group that does not divide the
    experts: the error raised.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config, reduced  # noqa: E402
from repro.core.disagg import DisaggPlan, DisaggregatedInstance  # noqa: E402
from repro.launch.serve import _inject_router_bias, zipf_router_bias  # noqa: E402
from repro.models import decode_step, init_params, prefill  # noqa: E402
from repro.serving.config import ServingConfig  # noqa: E402
from repro.serving.engine import Engine, Request  # noqa: E402
from repro.serving.prefill import PrefillWorker  # noqa: E402


def groups(case):
    devs = jax.devices()
    a, x, p = case.get("attn", 1), case.get("expert", 2), case.get("prefill", 0)
    return devs[:a], devs[a:a + x], devs[a + x:a + x + p]


def instance(cfg, params, case):
    attn, expert, _ = groups(case)
    return DisaggregatedInstance(cfg, params, attn_devices=attn,
                                 expert_devices=expert,
                                 plan=DisaggPlan(n_microbatches=case.get("m", 2),
                                                 use_m2n=case.get("m2n", False)))


def run(case, cfg, params):
    if case["kind"] == "refuse":
        try:
            instance(cfg, params, case)
        except Exception as e:          # noqa: BLE001 - the error is the result
            return {"error": f"{type(e).__name__}: {e}"}
        return {"error": None}
    if case.get("zipf"):
        params = _inject_router_bias(params, cfg,
                                     zipf_router_bias(cfg.moe.n_experts, case["zipf"]))
    if case["kind"] == "step":
        toks = jnp.asarray(case["tokens"])
        last, cache = prefill(params, cfg, toks, max_seq=case["max_seq"])
        nxt = jnp.argmax(last, -1)
        pos = jnp.full((toks.shape[0],), toks.shape[1], jnp.int32)
        want, _ = decode_step(params, cfg, nxt, cache, pos)
        got, _ = instance(cfg, params, case).decode_step(nxt, cache, pos)
        return {"mono": np.asarray(want, np.float32), "disagg": np.asarray(got, np.float32),
                "nxt": np.asarray(nxt)}
    kw = dict(max_batch=case["max_batch"], max_seq=case["max_seq"])
    mode = case["mode"]
    if mode != "mono":
        inst = instance(cfg, params, case)
        kw.update(mode="pingpong", runtime=inst)
        if case.get("rebalance"):
            kw["expert_rebalance_every"] = case["rebalance"]
        if mode == "worker":
            _, _, pre = groups(case)
            kw.update(prefill_worker=PrefillWorker(cfg, params, pre,
                                                   max_seq=case["max_seq"]),
                      transfer=case["transfer"], kv_sharding=inst.kv_sharding)
    if case.get("layout"):
        sc = ServingConfig(max_batch=case["max_batch"], max_seq=case["max_seq"],
                           runtime="pingpong" if mode != "mono" else "monolithic",
                           kv_layout=case["layout"], page_size=case.get("page_size", 8),
                           verbose=False)
        eng = Engine(cfg, params, config=sc,
                     **({"runtime": kw["runtime"]} if mode != "mono" else {}))
    else:
        eng = Engine(cfg, params, **kw)
    for i, p in enumerate(case["prompts"]):
        eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=case["max_new"]))
    toks = {r.rid: list(r.generated) for r in eng.run_until_done()}
    st = eng.stats()
    keep = {k: st[k] for k in ("imbalance", "rebalances", "replicated_experts",
                               "expert_loads", "kv_layout", "prefix_cache", "phases")
            if k in st}
    if "stages" in st:
        keep["stages"] = {k: st["stages"][k] for k in ("attn_n", "expert_n", "m2n_n",
                                                       "n2m_n")}
    return {"tokens": toks, "stats": keep}


if __name__ == "__main__":
    assert jax.device_count() == 8, jax.device_count()
    with open(sys.argv[1], "rb") as fh:
        cases = pickle.load(fh)
    models = {}
    for c in cases:
        arch = c.get("arch", "mixtral-8x22b")
        if arch not in models:
            cfg = reduced(get_config(arch))
            models[arch] = (cfg, init_params(cfg, jax.random.PRNGKey(0)))
    with open(sys.argv[2], "wb") as fh:
        pickle.dump({c["name"]: run(c, *models[c.get("arch", "mixtral-8x22b")])
                     for c in cases}, fh)
