"""Where the benchmark's data lives, found by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, per-layer
metric, kernel count or cell check is a file of its own:

  portbench/configs/<config>.json    sizes as run (BENCHMARK.json's ``file``)
  portbench/traffic/<traffic>.json   parameters of the general generator
  portbench/metrics/<metric>.py      a reader: ``read(run) -> float | None``
  portbench/work/<kernel>.py         needed FLOPs and bytes of each launch
  portbench/checks/<workload>.json   the limits that decide ``correct``
  portbench/reference/<name>.py      the plain reference a config names
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as a module named ``name`` (file names
    carry the metric's dots, which ``import`` does not take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's ``workloads`` with everything it
    names: its configuration and traffic files, its check limits, and
    the end-to-end and per-layer metrics it reports."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(PORTBENCH / "traffic" / f"{self.entry['traffic']}.json")
        check = PORTBENCH / "checks" / f"{workload}.json"
        self.check = load_json(check) if check.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"] if self._mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._mine(m)]

    @classmethod
    def of(cls, name: str, config: dict, traffic: dict, check: dict,
           end_to_end=(), per_layer=(), chips: int = 1) -> "Cell":
        """A cell made from the data itself (the tests' tiny cells)."""
        self = cls.__new__(cls)
        self.entry, self.name, self.chips = {}, name, chips
        self.config_entry, self.config = {}, config
        self.traffic, self.check = traffic, check
        self.end_to_end, self.per_layer = list(end_to_end), list(per_layer)
        return self

    def _mine(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def metric_readers(names: List[str]) -> Dict[str, ModuleType]:
    return {n: load_module(PORTBENCH / "metrics" / f"{n}.py",
                           "portbench_metric_" + n.replace(".", "_"))
            for n in names}


def work_module(kernel: str) -> ModuleType:
    return load_module(PORTBENCH / "work" / f"{kernel}.py",
                       "portbench_work_" + kernel.replace(".", "_"))


def reference_module(name: str) -> ModuleType:
    return load_module(PORTBENCH / "reference" / f"{name}.py",
                       "portbench_reference_" + name.replace(".", "_"))


def kernels_of(readers: Dict[str, ModuleType]) -> List[str]:
    """The kernels whose launches the traced run records: those a
    per-layer metric names in its ``KERNEL``."""
    out: List[str] = []
    for mod in readers.values():
        k: Optional[str] = getattr(mod, "KERNEL", None)
        if k and k not in out:
            out.append(k)
    return out
