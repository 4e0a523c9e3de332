"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``repro_torch/csrc/`` with a
plain C interface.  At first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``build/repro_torch_kernels/`` at
the repository root and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The library name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale one is never
loaded.  ``build_all`` compiles every registered source at once, one
``nvcc`` process per source.

Nothing here runs when the module is imported: the CPU tests import
every module on a machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# every kernel the port defines, by source file name
REGISTRY: Dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256()
    for part in (src.read_bytes(), (CSRC / "common.cuh").read_bytes(),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(sources: Sequence[str]) -> Dict[str, Path]:
    """Compile the sources that have no up-to-date library, all at once
    (one ``nvcc`` each), and return source -> library path.  Raises with
    the compiler's output if any build fails.  ``nvcc -Xptxas -v``'s
    register and shared-memory report is kept beside each library."""
    paths = {s: library_path(s) for s in sources}
    missing = {s: out for s, out in paths.items() if not out.exists()}
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s, out in missing.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / s)]
        procs.append((s, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, out, tmp, p in procs:
        log, _ = p.communicate()
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- {s} (exit {p.returncode})\n{log}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def build_all() -> Dict[str, Path]:
    return build(sorted(REGISTRY))


class CudaKernel:
    """One C entry point of one CUDA source, bound with ctypes.

    ``launches`` counts the launches made through ``launch`` and nothing
    else, so a run can show which kernels its path went through.  The C
    function takes the stream last and returns ``cudaGetLastError()``.
    """

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._fn = None
        self._errstr = None
        REGISTRY[source] = self

    def _bind(self):
        lib = ctypes.CDLL(str(build([self.source])[self.source]))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._errstr = lib.repro_error_string
        self._errstr.argtypes = [ctypes.c_int]
        self._errstr.restype = ctypes.c_char_p
        self._fn = fn

    def launch(self, device: torch.device, *args):
        """Launch on the current stream of ``device``; raises if the
        launch was refused."""
        if self._fn is None:
            self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: "
                               f"{self._errstr(rc).decode()} ({rc})")
        self.launches += 1


def reset_launch_counts():
    for k in REGISTRY.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {Path(s).stem: k.launches for s, k in REGISTRY.items()}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
