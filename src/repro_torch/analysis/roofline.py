"""Roofline of one rank's program in the dry run (``launch.dryrun``), the
JAX package's ``analysis/roofline.py`` on the port's measures.

Per (arch x shape x mesh):
  compute term    = FLOPs / peak FLOP/s             (one rank)
  memory term     = bytes accessed / HBM rate       (one rank)
  collective term = collective bytes / link rate    (one rank)

The FLOPs and bytes accessed are what one rank's program runs on the
``meta`` device (``torch.utils.flop_counter.FlopCounterMode`` and the sum
of every aten op's input and output bytes), and the collective bytes
what it hands its mesh's ``all_reduce`` (``launch.mesh.RecordingMesh``),
by kind.  The JAX package parses the collectives out of compiled HLO
text (``collective_bytes(hlo_text)``); the port has no HLO, so that
function is not ported and ``analyze`` takes the recorded bytes.  The
field names are the JAX record's (``hlo_flops``, ``hlo_bytes``,
``ici_bw``, ...), so one report reads both packages' records; here
``ici_bw`` is the NVLink rate.

Hardware constants: the NVIDIA H100 SXM data sheet's figures for that
card, not measurements: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 900 GB/s
NVLink per GPU (both directions summed).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # dense bf16 FLOP/s, H100 SXM data sheet
HBM_BW = 3.35e12           # HBM3 B/s, H100 SXM data sheet
ICI_BW = 900e9             # NVLink B/s per GPU, both directions, data sheet


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    model_flops: float                  # 6 * N_active * tokens (per chip share)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW
    per_device_mem: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def step_time_bound(self) -> float:
        """Roofline lower bound on step time (terms overlap perfectly)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU given the dominant term."""
        if self.step_time_bound == 0:
            return 0.0
        return (self.model_flops / self.peak_flops) / self.step_time_bound

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("t_compute", "t_memory", "t_collective", "bottleneck",
                  "useful_flops_ratio", "step_time_bound", "mfu_bound"):
            d[k] = getattr(self, k)
        return d

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} | "
                f"{self.t_collective*1e3:.2f} | **{self.bottleneck}** | "
                f"{self.useful_flops_ratio:.2f} | {self.mfu_bound:.2f} |")


def model_flops_estimate(cfg, shape_cfg, n_chips: int) -> float:
    """6*N*D rule (active params for MoE), per chip."""
    n_active = cfg.active_param_count()
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        mult = 6.0
    elif shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        mult = 2.0
    else:  # decode: one token per request
        tokens = shape_cfg.global_batch
        mult = 2.0
    return mult * n_active * tokens / n_chips


def analyze(arch: str, shape: str, mesh_name: str, n_chips: int,
            cost: dict, coll: Dict[str, int], model_flops: float,
            per_device_mem: Optional[float] = None) -> Roofline:
    """The roofline of one rank: ``cost`` its {"flops", "bytes accessed"},
    ``coll`` its collective bytes by kind (``RecordingMesh.bytes_by_kind``)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=dict(coll),
        model_flops=model_flops,
        per_device_mem=per_device_mem)


TABLE_HEADER = (
    "| arch | shape | mesh | T_comp (ms) | T_mem (ms) | T_coll (ms) "
    "| bottleneck | useful FLOP ratio | MFU bound |\n"
    "|---|---|---|---|---|---|---|---|---|")
