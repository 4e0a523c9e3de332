"""The port's multi-process slice on the CPU: ``MultiControllerTransport``
and ``DistributedSpec``, the process grid (``launch.mesh``), the port's
``dist_smoke`` and the M2N dispatch with one expert shard per process,
against the JAX package.

Ranks are processes over gloo, spawned by
``repro_torch.launch.dist_smoke.run_ranks`` with a ``file://`` store in
``tmp_path`` and a deadline of their own.  The JAX reference of the
m2n grid runs ``repro.core.m2n.sharded_routed_experts`` on the same
numpy params in a subprocess with 4 forced host devices (the pattern of
``tests/test_multidevice.py::run_sub``).  Tolerances: y at rtol = atol
= 2e-5 (the JAX ``dist_smoke``'s), counts exact, aux under
``weights_2d`` at rtol 1e-6.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import M2N_CASES, M2N_T
from repro_torch.core import transport as ttr
from repro_torch.core.transport import DistributedSpec, MultiControllerTransport
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.dist_smoke import run_ranks

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "_torch_dist_worker.py")
Y_TOL = dict(rtol=2e-5, atol=2e-5)


def _ranks(argv, n, tmp_path, timeout=120):
    out = run_ranks(argv, n, timeout=timeout,
                    coordinator=f"file://{tmp_path}/store")
    for rank, (rc, text) in enumerate(out):
        assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"
    return [text for _, text in out]


# ------------------------------------------------------------ transport
def test_multi_spec_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_COORDINATOR", "10.0.0.1:999")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "4")
    monkeypatch.setenv("REPRO_PROCESS_ID", "3")
    assert DistributedSpec.from_env() == DistributedSpec("10.0.0.1:999", 4, 3)


def test_multi_spec_mpi_fallback(monkeypatch):
    monkeypatch.delenv("REPRO_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("REPRO_PROCESS_ID", raising=False)
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "1")
    spec = DistributedSpec.from_env()
    assert (spec.num_processes, spec.process_id) == (2, 1)


def test_multi_spec_fields_and_defaults_match_jax():
    jtr = pytest.importorskip("repro.core.transport")
    assert DistributedSpec() == DistributedSpec(**vars(jtr.DistributedSpec()))


def test_single_process_multi_backend_degenerates():
    """num_processes = 1: no bring-up; a hop hands the tensors over as
    the in-process one does, and the ledger names the backend."""
    tr = ttr.make_transport("multi", spec=DistributedSpec(num_processes=1))
    assert not torch.distributed.is_initialized()
    assert (tr.process_index, tr.process_count, tr.backend) == (0, 1, "gloo")
    x = torch.arange(4.0)
    h = tr.send(x, sync=True)
    assert h.data is x and h.nbytes == 16
    assert tr.stats()["backend"] == "multi"
    moved = MultiControllerTransport(DistributedSpec(), device="cpu")
    assert moved.send_tokens(x).data.device.type == "cpu"
    assert torch.equal(tr.gather({"a": [x]})["a"][0], x)


def test_registry_has_multi():
    assert set(ttr.TRANSPORTS) == {"inproc", "simrdma", "multi"}
    assert isinstance(ttr.make_transport("multi"), MultiControllerTransport)


def test_serving_config_accepts_multi():
    from repro_torch.serving.config import ServingConfig
    assert ServingConfig(transport="multi").transport == "multi"
    with pytest.raises(ValueError, match="transport"):
        ServingConfig(transport="pigeon")


def test_serve_multi_is_inproc_in_one_process():
    """``transport="multi"`` in one process serves the tokens of
    ``inproc`` (ping-pong, m2n over 2 expert nodes) and reports its
    backend and the same hops."""
    from repro_torch.launch.serve import build
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import Request
    runs = {}
    for name in ("inproc", "multi"):
        sc = ServingConfig(device="cpu", runtime="pingpong", microbatches=2,
                           use_m2n=True, expert_nodes=2, transport=name,
                           verbose=False)
        _, eng = build(sc)
        rng = np.random.RandomState(0)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=rng.randint(2, 100, 6).tolist(),
                               max_new_tokens=3))
        runs[name] = ({r.rid: r.generated for r in eng.run_until_done()},
                      eng.stats()["transport"])
    assert runs["multi"][0] == runs["inproc"][0] and len(runs["inproc"][0]) == 3
    assert runs["multi"][1]["backend"] == "multi"
    for kind in ("tokens", "collective"):
        assert runs["multi"][1][kind]["bytes"] == runs["inproc"][1][kind]["bytes"] > 0


# ------------------------------------------------------------------ mesh
def test_mesh_of_one_process_and_split_serving_devices():
    m = tmesh.make_mesh((1, 1), ("data", "model"))
    assert m.shape == {"data": 1, "model": 1} and m.axis_names == ("data", "model")
    assert m.index("data") == m.index(("data", "model")) == 0
    assert m.group("model") is None
    t = torch.ones(3)
    assert m.all_reduce(t, "model") is t and torch.equal(t, torch.ones(3))
    assert tmesh.data_axes(m) == ("data",) and tmesh.model_axis(m) == "model"
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_mesh((2, 1), ("data", "model"))
    devs = [torch.device("cpu")] * 3
    assert tmesh.split_serving_devices(1, devs) == (devs[-1:], devs[:-1])
    assert tmesh.split_serving_devices(0, devs) == ([], devs)
    assert tmesh.split_serving_devices(3, devs) == (devs, devs)   # shared pool


# ------------------------------------------------------------ dist_smoke
@pytest.mark.parametrize("procs", [2, 4])
def test_dist_smoke_cpu(procs):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dist_smoke",
                        "--device", "cpu", "--procs", str(procs), "--timeout", "90"],
                       env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for pid in range(procs):
        assert f"dist-smoke OK p{pid}/{procs} device=cpu transport=multi " \
               f"backend=gloo" in r.stdout
    assert "dist-smoke: OK" in r.stdout


def test_dist_smoke_fails_on_a_hung_rank(tmp_path):
    """A rank that never finishes is killed at the deadline, with the
    others, and shows as failed."""
    out = run_ranks(["-c", "import time, os; time.sleep(0 if "
                     "os.environ['REPRO_PROCESS_ID'] == '0' else 60)"], 2,
                    timeout=3, coordinator=f"file://{tmp_path}/s")
    assert out[0][0] == 0 and out[1][0] == -9 and "TIMEOUT" in out[1][1]


# ------------------------------------------------------ m2n vs JAX grid
JAX_M2N = """
import sys, numpy as np, jax
sys.path.insert(0, {tests!r})
from _torch_dist_worker import M2N_CASES, M2N_F, M2N_K, m2n_case
from repro.config import MoEConfig
from repro.core import m2n
from repro.launch.mesh import make_mesh
assert jax.device_count() == 4, jax.device_count()
out = {{}}
for name, shape, dax, E, w2d, mode in M2N_CASES:
    p, x = m2n_case(E)
    cfg = MoEConfig(n_experts=E, top_k=M2N_K, d_ff_expert=M2N_F)
    mesh = make_mesh(shape, ("data", "model"))
    with mesh:
        y, aux, counts = jax.jit(lambda p, x: m2n.sharded_routed_experts(
            p, x, cfg, "silu", mode, mesh=mesh, data_axes=dax,
            expert_axis="model", weights_2d=w2d, with_counts=True))(p, x)
    out.update({{name + "/y": np.asarray(y), name + "/aux": np.asarray(aux),
                name + "/counts": np.asarray(counts)}})
np.savez({path!r}, **out)
print("JAX-M2N-OK")
"""


@pytest.fixture(scope="module")
def m2n_runs(tmp_path_factory):
    """(JAX results, [each rank's results]) of every case of M2N_CASES."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("m2n")
    ref = str(tmp / "jax.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_M2N.format(tests=TESTS, path=ref)],
                       env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0 and "JAX-M2N-OK" in r.stdout, r.stderr[-3000:]
    _ranks([WORKER, "m2n", str(tmp)], 4, tmp)
    return np.load(ref), [np.load(tmp / f"rank{k}.npz") for k in range(4)]


@pytest.mark.parametrize("case", M2N_CASES, ids=[c[0] for c in M2N_CASES])
def test_m2n_over_4_ranks_matches_jax_grid(m2n_runs, case):
    """Every rank's rows of y and the counts against the JAX dispatch on
    the same grid of forced host devices (2 data x 2 model, and 1 x 4);
    under ``weights_2d`` the aux too (the plain branch's loss, averaged
    over the data ranks)."""
    name, shape, dax, E, w2d, mode = case
    want, ranks = m2n_runs
    n_data = shape[0]
    t = M2N_T // n_data
    for k, got in enumerate(ranks):
        i = int(got[f"{name}/rows"])
        assert i == k // shape[1]
        np.testing.assert_allclose(got[f"{name}/y"], want[f"{name}/y"][i * t:(i + 1) * t],
                                   **Y_TOL, err_msg=f"{name} rank {k}")
        np.testing.assert_array_equal(got[f"{name}/counts"], want[f"{name}/counts"])
        assert got[f"{name}/counts"].sum() == M2N_T * 2
        if w2d:
            np.testing.assert_allclose(got[f"{name}/aux"], want[f"{name}/aux"],
                                       rtol=1e-6)
            assert float(want[f"{name}/aux"]) > 0
        else:
            assert float(got[f"{name}/aux"]) == 0.0     # the kernel path's


def test_m2n_mesh_refusals():
    from repro_torch.config import MoEConfig
    from repro_torch.core.m2n import expert_shard, sharded_routed_experts
    cfg = MoEConfig(n_experts=6, top_k=2, d_ff_expert=16)
    p = {"router": torch.randn(8, 6), "we1": torch.randn(6, 8, 16),
         "we3": torch.randn(6, 8, 16), "we2": torch.randn(6, 16, 8)}
    x = torch.randn(4, 8)
    m = tmesh.make_mesh((1,), ("model",))
    with pytest.raises(ValueError, match="data axis"):
        sharded_routed_experts(p, x, cfg, "silu", "full", n_shards=2,
                               data_axes=("data",))
    with pytest.raises(ValueError, match="n_shards"):
        sharded_routed_experts(p, x, cfg, "silu", "full", n_shards=2, mesh=m)
    with pytest.raises(ValueError, match="rows"):
        sharded_routed_experts(dict(p, we1=p["we1"][:2]), x, cfg, "silu", "full",
                               mesh=m)
    with pytest.raises(NotImplementedError, match="tables"):
        sharded_routed_experts(p, x, cfg, "silu", "full", mesh=m, weights_2d=True,
                               tables={"slots_per_node": 6})
    with pytest.raises(ValueError, match="split"):
        expert_shard(p, cfg, 2, 0, n_data=3)
    # shard 3 of 4 holds none of the 6 experts (8 buckets)
    assert expert_shard(p, cfg, 4, 3)["we1"].shape == (0, 8, 16)
    assert expert_shard(p, cfg, 2, 1, n_data=2, i=1)["we2"].shape == (3, 8, 8)
    # one rank, one shard: the mesh path is the in-process path
    y1 = sharded_routed_experts(p, x, cfg, "silu", "full", mesh=m)
    y0 = sharded_routed_experts(p, x, cfg, "silu", "full", n_shards=1)
    assert torch.equal(y1, y0)
