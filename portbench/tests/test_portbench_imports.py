"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the port.  Each check runs in a fresh
interpreter, comparing the top-level name of every loaded module whole."""
import json
import subprocess
import sys

import portbench_tiny

PROBE = r"""
import json, sys
sys.path[:0] = [{src!r}, {pb!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str):
    code = PROBE.format(src=str(portbench_tiny.ROOT / "src"),
                        pb=str(portbench_tiny.PORTBENCH), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_metrics_and_port_load_no_jax():
    names = loaded(
        "import run\n"
        "from harness import bench, check, serve, spec, trace, traffic, weights, window\n"
        "spec.metric_readers([p.stem for p in (spec.PORTBENCH / 'metrics').glob('*.py')])\n"
        "[spec.work_module(p.stem) for p in (spec.PORTBENCH / 'work').glob('*.py')]\n"
        "import repro_torch.launch.serve, repro_torch.serving.engine\n")
    assert "repro_torch" in names and "harness" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names


def test_reference_loads_nothing_of_the_port():
    names = loaded("from harness import spec\n"
                   "for p in (spec.PORTBENCH / 'reference').glob('*.py'):\n"
                   "    spec.reference_module(p.stem)\n")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, names


def test_run_refuses_a_tree_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copy(portbench_tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(portbench_tiny.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "mixtral-8L-chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_a_card():
    """Here there is no card: exit non-zero, no result line."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "mixtral-8L-chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=portbench_tiny.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(portbench_tiny.ROOT / "build")})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
