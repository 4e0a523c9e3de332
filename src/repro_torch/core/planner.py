"""Deployment plan search (paper §4.2 Algorithm 1 + §4.3 heterogeneous),
copied from the JAX package's ``core/planner.py`` so the port imports
nothing of it.

Given an MoE model, a hardware pair (attention nodes, expert nodes), and
an SLO, searches (tp_a, tp_e, n_a, m, B) to maximize decoding throughput
per unit cost.  The performance model follows the paper:

  T_a = k1 * b_a + k2      (attention node, memory-bound: KV + weights)
  T_e = k3 * b_e + k4      (expert node, roofline over FFN GEMMs)
  T_c = eq. (6)            (per-micro-batch M2N transfer, alpha-beta)

with  b_a = B/(m*n_a),  b_e = B*K/(m*E),  n_a balancing T_a ~= T_e.
Instead of profiling k_i on hardware (paper's approach, unavailable
here), we derive them from first-principles roofline over the GEMM
inventory of Table 2 — each GEMM contributes max(flops/F, bytes/BW).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.config import ModelConfig
from repro_torch.core import pingpong

# ---------------------------------------------------------------------------
# hardware registry (paper Table 3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Hardware:
    name: str
    price: float          # normalized (L20 = 1.0), paper Table 3
    mem_gb: float
    hbm_gbps: float       # GB/s
    tflops: float         # bf16 dense
    net_gbps: float = 25.0     # per-chip inter-node network, GB/s (200Gb IB)
    intra_gbps: float = 200.0  # per-chip intra-node (NVLink/ICI), GB/s
    net_alpha_us: float = 15.0  # per-message launch latency


HARDWARE = {h.name: h for h in [
    Hardware("L20", 1.00, 48, 864, 119.5, net_gbps=25, intra_gbps=32),
    Hardware("H800", 5.28, 80, 3430.4, 989, net_gbps=50, intra_gbps=200),
    Hardware("A800", 2.26, 80, 2039, 312, net_gbps=25, intra_gbps=200),
    Hardware("A100", 2.26, 80, 2039, 312, net_gbps=25, intra_gbps=300),
    Hardware("H20", 1.85, 96, 4096, 148, net_gbps=50, intra_gbps=450),
    Hardware("L40S", 1.08, 48, 864, 362, net_gbps=25, intra_gbps=32),
    # the six GPU rows of the paper's Table 3 only: the port never runs on
    # a TPU, so the JAX package's TPU rows are left out
]}

BYTES = 2  # bfloat16


# ---------------------------------------------------------------------------
# performance model
# ---------------------------------------------------------------------------


def _gemm_time(b: float, m: int, n: int, hw: Hardware, tp: int) -> float:
    """Roofline time (s) of a (b x m) @ (m x n) GEMM split tp-ways."""
    flops = 2.0 * b * m * n / tp
    bytes_w = BYTES * m * n / tp
    return max(flops / (hw.tflops * 1e12), bytes_w / (hw.hbm_gbps * 1e9))


def attn_time(cfg: ModelConfig, b_a: float, s: float, hw: Hardware,
              tp_a: int) -> float:
    """T_a: QKV-project + attn-output GEMMs + KV-cache access + TP sync."""
    h = cfg.d_model
    hd = cfg.resolved_head_dim
    q_dim = cfg.n_heads * hd
    kv_dim = cfg.n_kv_heads * hd
    t = _gemm_time(b_a, h, q_dim + 2 * kv_dim, hw, tp_a)   # QKV project
    t += _gemm_time(b_a, q_dim, h, hw, tp_a)               # attn output
    # KV cache read: b_a * s * 2 (K and V) * kv_dim bytes (memory-bound)
    kv_bytes = b_a * s * 2 * kv_dim * BYTES / tp_a
    t += kv_bytes / (hw.hbm_gbps * 1e9)
    # intra-node TP all-reduce: b_a * h * 2(tp-1)/tp elements
    if tp_a > 1:
        sync = 2 * b_a * h * BYTES * (tp_a - 1) / tp_a
        t += sync / (hw.intra_gbps * 1e9)
    return t


def expert_time(cfg: ModelConfig, b_e: float, hw: Hardware, tp_e: int,
                n_ffn_mats: int = 3) -> float:
    """T_e: FFN GEMMs (gated MLP => 3 mats; paper's 2-mat model if set)."""
    h = cfg.d_model
    ff = cfg.moe.d_ff_expert if cfg.moe else cfg.d_ff
    t = n_ffn_mats * _gemm_time(b_e, h, ff, hw, tp_e)
    if tp_e > 1:
        sync = 2 * b_e * h * BYTES * (tp_e - 1) / tp_e
        t += sync / (hw.intra_gbps * 1e9)
    return t


def comm_time(cfg: ModelConfig, b_a: float, b_e: float, hw_a: Hardware,
              hw_e: Hardware, tp_a: int, tp_e: int) -> float:
    """T_c, paper eq. (6): max(attention-side send, expert-side receive)."""
    h = cfg.d_model
    K = cfg.moe.top_k if cfg.moe else 1
    send = b_a * h * K * BYTES / tp_a
    recv = b_e * h * BYTES / tp_e
    t_send = hw_a.net_alpha_us * 1e-6 + send / (hw_a.net_gbps * 1e9)
    t_recv = hw_e.net_alpha_us * 1e-6 + recv / (hw_e.net_gbps * 1e9)
    return max(t_send, t_recv)


def attn_param_bytes(cfg: ModelConfig) -> float:
    h, hd = cfg.d_model, cfg.resolved_head_dim
    per_layer = h * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * h
    dense_extra = 0.0
    if cfg.moe is not None:  # shared experts / dense residual ride with attention
        m = cfg.moe
        dense_extra = 3 * h * (m.d_ff_shared * bool(m.n_shared_experts)
                               + m.d_ff_dense_residual)
    return (per_layer + dense_extra) * cfg.n_layers * BYTES + 2 * cfg.vocab * h * BYTES


def expert_param_bytes(cfg: ModelConfig) -> float:
    """Parameters of ONE expert across all layers (one expert node holds one
    expert per layer, paper §3)."""
    ff = cfg.moe.d_ff_expert if cfg.moe else cfg.d_ff
    return 3 * cfg.d_model * ff * cfg.n_layers * BYTES


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------


@dataclass
class Plan:
    tp_a: int
    tp_e: int
    n_a: int
    m: int
    global_batch: int
    hw_attn: str
    hw_expert: str
    t_a: float
    t_e: float
    t_c: float
    t_iter: float
    throughput: float          # tokens/s per instance
    n_gpus: int
    cost: float                # normalized price units
    tpd: float                 # throughput per dollar
    per_gpu_tput: float

    def summary(self) -> str:
        return (f"tp_a={self.tp_a} tp_e={self.tp_e} n_a={self.n_a} m={self.m} "
                f"B={self.global_batch} hw=({self.hw_attn},{self.hw_expert}) "
                f"T_a={self.t_a*1e3:.2f}ms T_e={self.t_e*1e3:.2f}ms "
                f"T_c={self.t_c*1e3:.2f}ms TPOT={self.t_iter*1e3:.1f}ms "
                f"tput={self.throughput:.0f}tok/s tpd={self.tpd:.1f}")


def _simulate(cfg: ModelConfig, hw_a: Hardware, hw_e: Hardware, tp_a: int,
              tp_e: int, n_a: int, m: int, B: int, s: float):
    E = cfg.moe.n_experts if cfg.moe else 1
    K = cfg.moe.top_k if cfg.moe else 1
    b_a = B / (m * n_a)
    b_e = B * K / (m * E)
    t_a = attn_time(cfg, b_a, s, hw_a, tp_a)
    t_e = expert_time(cfg, b_e, hw_e, tp_e)
    t_c = comm_time(cfg, b_a, b_e, hw_a, hw_e, tp_a, tp_e)
    t_iter = pingpong.iteration_latency(t_a, t_e, t_c, m, cfg.n_layers)
    return t_a, t_e, t_c, t_iter


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    return 2 * cfg.n_kv_heads * cfg.resolved_head_dim * cfg.n_layers * BYTES


def max_batch_for_memory(cfg: ModelConfig, hw_a: Hardware, tp_a: int,
                         n_a: int, m: int, s: float) -> int:
    """Constraint (8): KV cache for the whole in-flight batch fits."""
    cap = hw_a.mem_gb * 1e9 * tp_a * 0.9
    free = cap - 2.0 * attn_param_bytes(cfg) / 1.0
    if free <= 0:
        return 0
    per_req = s * kv_bytes_per_token(cfg)
    return int(free / per_req) * n_a


def search_plan(cfg: ModelConfig, *, hw_attn: str = "A100",
                hw_expert: Optional[str] = None, slo_s: float = 0.150,
                seq_len: float = 730.0, max_tp: int = 8, n_m: int = 4,
                max_attn_nodes: int = 64) -> Optional[Plan]:
    """Paper Algorithm 1: enumerate (tp_e, tp_a, m), balance n_a, binary
    search B under the SLO, maximize throughput-per-dollar."""
    hw_a = HARDWARE[hw_attn]
    hw_e = HARDWARE[hw_expert or hw_attn]
    E = cfg.moe.n_experts if cfg.moe else 1
    K = cfg.moe.top_k if cfg.moe else 1
    best: Optional[Plan] = None
    tps = [t for t in (1, 2, 4, 8) if t <= max_tp]
    for tp_e in tps:
        if tp_e * hw_e.mem_gb * 1e9 <= expert_param_bytes(cfg):
            continue
        for tp_a in tps:
            if tp_a * hw_a.mem_gb * 1e9 <= 2 * attn_param_bytes(cfg):
                continue
            # BALANCE: n_a s.t. T_a(b_a) ~= T_e(b_e)  (paper: n_a = k1 E / k3 K)
            k1 = (attn_time(cfg, 512, seq_len, hw_a, tp_a)
                  - attn_time(cfg, 256, seq_len, hw_a, tp_a)) / 256.0
            k3 = (expert_time(cfg, 512, hw_e, tp_e)
                  - expert_time(cfg, 256, hw_e, tp_e)) / 256.0
            n_a = max(1, round(k1 * E / (k3 * K)))
            n_a = min(n_a, max_attn_nodes)
            for m in range(3, n_m + 1):
                # binary search max B under SLO + memory
                b_mem = max_batch_for_memory(cfg, hw_a, tp_a, n_a, m, seq_len)
                lo, hi = 0, max(1, b_mem)
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    _, _, _, t_iter = _simulate(cfg, hw_a, hw_e, tp_a, tp_e,
                                                n_a, m, mid, seq_len)
                    if t_iter <= slo_s:
                        lo = mid
                    else:
                        hi = mid - 1
                B = lo
                if B < m * n_a:  # at least one token per micro-batch per node
                    continue
                t_a, t_e, t_c, t_iter = _simulate(cfg, hw_a, hw_e, tp_a, tp_e,
                                                  n_a, m, B, seq_len)
                n_gpus = tp_a * n_a + tp_e * E
                cost = tp_a * n_a * hw_a.price + tp_e * E * hw_e.price
                tput = pingpong.throughput(B, t_iter)
                plan = Plan(tp_a, tp_e, n_a, m, B, hw_a.name, hw_e.name,
                            t_a, t_e, t_c, t_iter, tput, n_gpus, cost,
                            tput / cost, tput / n_gpus)
                if best is None or plan.tpd > best.tpd:
                    best = plan
    return best


def search_heterogeneous(cfg: ModelConfig, candidates=None, **kw) -> Plan:
    """§4.3: enumerate hardware pairs, return the best plan per dollar."""
    candidates = candidates or ["H20", "L40S", "A100", "L20"]
    best = None
    for ha in candidates:
        for he in candidates:
            p = search_plan(cfg, hw_attn=ha, hw_expert=he, **kw)
            if p and (best is None or p.tpd > best.tpd):
                best = p
    return best
