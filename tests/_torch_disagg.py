"""Shared set-up of ``tests/test_torch_disagg_ranks*.py``: reduced
mixtral's JAX params and prompts, the JAX reference child
(``tests/_torch_disagg_ref.py``, 8 forced host devices) started beside
the port's gloo ranks (``tests/_torch_dist_worker.py disagg``), and the
port's one-process engine over the same params."""
import os
import pickle
import subprocess
import sys

import numpy as np

from repro_torch.launch.dist_smoke import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
REF = os.path.join(HERE, "_torch_disagg_ref.py")
ENGINE = dict(max_batch=4, max_seq=64)


def jax_params(arch="mixtral-8x22b"):
    """A reduced config's JAX ``init_params(PRNGKey(0))`` as numpy."""
    import jax

    from repro import config as jconfig
    from repro.models import transformer as jtf
    cfg = jconfig.reduced(jconfig.get_config(arch))
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0)))


def prompts(n=5, seed=0):
    """``tests/test_multidevice.py``'s prompts: n of 2 to 7 tokens."""
    rng = np.random.RandomState(seed)
    return [rng.randint(2, 512, size=rng.randint(2, 8)).tolist() for _ in range(n)]


def shared_prompts(n=5, seed=0):
    """Its paged test's prompts: a 16-token head (two 8-slot pages) and a
    tail of 3 to 7 tokens."""
    rng = np.random.RandomState(seed)
    head = rng.randint(2, 512, size=16).tolist()
    return [head + rng.randint(2, 512, size=rng.randint(3, 8)).tolist()
            for _ in range(n)]


def run(tmp, jax_cases, rank_runs, timeout=150):
    """Start the JAX child on ``jax_cases``, then each (world, cases) of
    ``rank_runs`` on that many gloo ranks (one deadline each).  Returns
    (JAX results by name, {case name: [each rank's result]})."""
    with open(tmp / "jax_in.pkl", "wb") as fh:
        pickle.dump(jax_cases, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    env.pop("XLA_FLAGS", None)
    child = subprocess.Popen([sys.executable, REF, str(tmp / "jax_in.pkl"),
                              str(tmp / "jax_out.pkl")], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
    got = {}
    try:
        for world, cases in rank_runs:
            d = tmp / f"w{world}"
            d.mkdir()
            with open(d / "in.pkl", "wb") as fh:
                pickle.dump(cases, fh)
            out = run_ranks([WORKER, "disagg", str(d / "in.pkl"), str(d)], world,
                            timeout=timeout, coordinator=f"file://{d}/store")
            for rank, (rc, text) in enumerate(out):
                assert rc == 0, f"{world} ranks: rank {rank} exit {rc}:\n{text[-3000:]}"
            ranks = []
            for r in range(world):
                with open(d / f"disagg{r}.pkl", "rb") as fh:
                    ranks.append(pickle.load(fh))
            for case in cases:
                got[case["name"]] = [r[case["name"]] for r in ranks]
        text, _ = child.communicate(timeout=300)
    finally:
        child.kill()
    assert child.returncode == 0, text[-3000:]
    with open(tmp / "jax_out.pkl", "rb") as fh:
        return pickle.load(fh), got


def one_process(params_np, case):
    """The port's engine of ``case`` in one process (the in-process
    transport, ``case``'s expert count as expert nodes): its tokens and
    stats."""
    import torch

    from repro_torch.bridge import params_from_jax
    from repro_torch.config import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import Request

    cfg = reduced(get_config("mixtral-8x22b"))
    params = params_from_jax(params_np, cfg, device="cpu")
    if case.get("zipf"):
        serve.inject_router_bias(params, cfg, serve.zipf_router_bias(
            cfg.moe.n_experts, case["zipf"]))
    sc = ServingConfig(device="cpu", runtime="pingpong", microbatches=case.get("m", 2),
                       use_m2n=case.get("m2n", False),
                       expert_nodes=len(case.get("expert_ranks", (0, 0))),
                       prefill_devices=case.get("prefill", 0),
                       transfer=case.get("transfer", "async"),
                       kv_layout=case.get("layout", "contiguous"),
                       page_size=case.get("page_size", 8),
                       expert_rebalance_every=case.get("rebalance", 0),
                       verbose=False, **ENGINE)
    eng = serve.engine_for(sc, cfg, params)
    for i, p in enumerate(case["prompts"]):
        eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=case["max_new"]))
    with torch.no_grad():
        done = eng.run_until_done()
    return {r.rid: list(r.generated) for r in done}, eng.stats()
