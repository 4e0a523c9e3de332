"""Multi-process transport smoke of the port: the M2N dispatch run
through ``MultiControllerTransport``, one expert shard per process.

The parent spawns N worker processes, hands them coordinator and rank
through the ``REPRO_*`` env vars, and checks that every worker exits
cleanly within the time limit (a worker that hangs is killed, with all
the others, and fails the run).  Each worker

  1. brings up ``MultiControllerTransport`` (``torch.distributed``; gloo
     on the CPU and where the ranks share a card, as here with every
     rank on ``cuda:0``);
  2. builds the global one-axis "ep" grid over all N ranks;
  3. uploads the replicated tokens and router, and its own expert
     slice, through ``send_tokens`` / ``regather_weights`` (the
     multihost convention: each rank passes its host-local view);
  4. runs ``core.m2n.sharded_routed_experts`` over the grid: rank j runs
     expert shard j (the ``gating_dispatch`` owner branch and the
     grouped MLP), and the combine is an ``all_reduce`` across the
     processes;
  5. checks the gathered output against the single-process dense
     oracle (the plain ``routed_experts_dense``) at rtol = atol = 2e-5,
     and that the counts sum to T * K;
  6. sends a KV hop and checks that every hop kind was counted;
  7. prints an OK line and a ``launches {...}`` JSON line of its kernel
     launch counts.

One JAX process holds K forced host devices, while one process here is
one rank on one device: the JAX smoke's ``--procs 2 --local-devices 2``
(4 expert shards) corresponds to ``--procs 4`` here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dist_smoke --procs 2
      (every rank on the card, gloo; the kernels are built first)
  PYTHONPATH=src python -m repro_torch.launch.dist_smoke --device cpu --procs 4
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ENV_COORD = "REPRO_COORDINATOR"
ENV_NPROC = "REPRO_NUM_PROCESSES"
ENV_PID = "REPRO_PROCESS_ID"
SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, procs: int, *, timeout: float = 300.0,
              coordinator: str | None = None, env: dict | None = None):
    """Run ``[python] + argv`` as ``procs`` ranks (``REPRO_*`` set, one
    OpenMP thread each, ``src`` on the path) and wait for all of them
    under one deadline; on the deadline every rank still running is
    killed.  Returns [(exit code, output)] per rank, -9 for a killed one."""
    coord = coordinator or f"127.0.0.1:{_free_port()}"
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = SRC + os.pathsep + base.get("PYTHONPATH", "")
    base.setdefault("OMP_NUM_THREADS", "1")
    children = [subprocess.Popen(
        [sys.executable] + list(argv),
        env=dict(base, **{ENV_COORD: coord, ENV_NPROC: str(procs),
                          ENV_PID: str(pid)}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(procs)]
    deadline = time.monotonic() + timeout
    out = []
    try:
        for ch in children:
            try:
                text, _ = ch.communicate(timeout=max(0.0, deadline - time.monotonic()))
                out.append((ch.returncode, text))
            except subprocess.TimeoutExpired:
                ch.kill()
                text, _ = ch.communicate()
                out.append((-9, text + "\n[parent] TIMEOUT"))
    finally:
        for ch in children:
            if ch.poll() is None:
                ch.kill()
                ch.communicate()
    return out + [(-9, "[parent] TIMEOUT")] * (procs - len(out))


# --------------------------------------------------------------- worker
def worker(device: str) -> None:
    import numpy as np
    import torch

    from repro_torch.config import MoEConfig
    from repro_torch.core.m2n import expert_shard, sharded_routed_experts
    from repro_torch.core.transport import MultiControllerTransport
    from repro_torch.kernels.cuda_build import launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_lib

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    transport = MultiControllerTransport(device=device)
    nproc, pid = transport.process_count, transport.process_index
    mesh = make_mesh((nproc,), ("ep",), device=device)

    # -- a small MoE every process can hold fully (the oracle needs it)
    E, d, f, T, K = 2 * nproc, 16, 32, 16, 2
    cfg = MoEConfig(n_experts=E, top_k=K, d_ff_expert=f)
    rng = np.random.RandomState(0)  # same params on every process
    params = {
        "router": rng.randn(d, E),
        "we1": rng.randn(E, d, f) / np.sqrt(d),
        "we3": rng.randn(E, d, f) / np.sqrt(d),
        "we2": rng.randn(E, f, d) / np.sqrt(f),
    }
    x = rng.randn(T, d).astype(np.float32)
    host = {k: torch.from_numpy(v.astype(np.float32)) for k, v in params.items()}
    y_ref, _ = moe_lib.routed_experts_dense(host, torch.from_numpy(x), cfg,
                                            "silu", "full")

    # -- upload: tokens and router replicated, this rank's expert slice
    x_g = transport.send_tokens(torch.from_numpy(x)).data
    router_g = transport.regather_weights({"router": host["router"]}).data
    mine = expert_shard(host, cfg, nproc, mesh.index("ep"))
    w_g = transport.regather_weights(
        {k: mine[k] for k in ("we1", "we3", "we2")}).data

    # -- the M2N dispatch over the grid: routing replicated on every
    #    expert shard, combine all-reduced over "ep" across processes
    y, counts = sharded_routed_experts(
        dict(w_g, router=router_g["router"]), x_g, cfg, "silu", "full",
        mesh=mesh, expert_axis="ep", with_counts=True, transport=transport)
    y_host, counts_host = transport.gather((y, counts))
    np.testing.assert_allclose(y_host.numpy(), y_ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert float(counts_host.sum()) == T * K, counts_host

    # -- KV hop + ledger checks
    kv = {"k": torch.zeros((4, 1, 8, 2)), "v": torch.zeros((4, 1, 8, 2))}
    transport.migrate_kv(kv, sync=True)
    st = transport.stats()
    assert st["backend"] == "multi", st
    for kind in ("tokens", "kv", "weights", "collective"):
        assert st[kind]["hops"] >= 1, (kind, st)
        if kind != "collective":
            assert st[kind]["bytes"] > 0, (kind, st)
    print(f"dist-smoke OK p{pid}/{nproc} device={y.device} "
          f"transport={st['backend']} backend={transport.backend}", flush=True)
    print("launches " + json.dumps(launch_counts()), flush=True)
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------- parent
def launch(procs: int, device: str, timeout: float = 300.0) -> int:
    if device.startswith("cuda"):
        import torch

        from repro_torch.device import resolve_device
        from repro_torch.kernels.cuda_build import build_all
        resolve_device(device)
        build_all()                 # the ranks load the cached libraries
        torch.cuda.empty_cache()
    rc = 0
    for pid, (code, out) in enumerate(run_ranks(
            ["-m", "repro_torch.launch.dist_smoke", "--child", "--device", device],
            procs, timeout=timeout)):
        print(f"--- worker {pid} (exit {code}) ---")
        print(out.strip())
        rc = rc or code or (1 if f"dist-smoke OK p{pid}/" not in out else 0)
    print("dist-smoke:", "OK" if rc == 0 else f"FAILED (rc={rc})")
    return 1 if rc else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2,
                    help="number of processes, one expert shard each")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; every rank on the card it is bound "
                         "to) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)  # internal: worker entry
    args = ap.parse_args(argv)
    if args.child:
        worker(args.device)
        return
    raise SystemExit(launch(args.procs, args.device, args.timeout))


if __name__ == "__main__":
    main()
