"""Serving launcher of the port: the continuous-batching engine over the
monolithic decode path, the disaggregated runtime (``disagg``) or the
ping-pong pipeline, optionally with prefill on the prefill worker
(``--prefill-devices``), on the card unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.serve --reduced --runtime pingpong \\
      --microbatches 2 --requests 8 --max-new 8
  python -m repro_torch.launch.serve --arch mixtral-8x22b --n-layers 4 \\
      --dtype bfloat16 --runtime pingpong --microbatches 2 --max-batch 8
  python -m repro_torch.launch.serve --reduced --device cpu \\
      --runtime pingpong --microbatches 2 --kv-layout paged --page-size 8 \\
      --prompt-len 32 --shared-prefix-len 24
  python -m repro_torch.launch.serve --reduced --device cpu \\
      --runtime pingpong --microbatches 2 --expert-nodes 4 \\
      --zipf-route-bias 1.2 --expert-rebalance-every 2 --use-m2n
  python -m repro_torch.launch.serve --reduced --device cpu \
      --runtime pingpong --microbatches auto --prefill-devices 1 \
      --transfer async
  # across 4 ranks (start one process per REPRO_PROCESS_ID): 1 prefill,
  # 1 attention and 2 expert ranks
  REPRO_COORDINATOR=127.0.0.1:29513 REPRO_NUM_PROCESSES=4 REPRO_PROCESS_ID=0 \
      python -m repro_torch.launch.serve --reduced --device cpu \
      --runtime pingpong --microbatches 2 --prefill-devices 1 \
      --transport multi --use-m2n

With ``--transport multi`` and more than one process (the ``REPRO_*``
variables, or OpenMPI's / SLURM's) the engine serves on the JAX
launcher's layout of ranks (``launch.mesh.ServingRoles``): the last
``--prefill-devices`` ranks prefill, the first half of the others run
attention, the rest the experts.  Each rank draws from the seed only
what its role reads, each leaf cut as it is drawn; rank 0 prints.  In one process ``multi`` is the in-process hop.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.config import get_config, reduced
from repro_torch.core.disagg import (STAGES, WAITS, DisaggPlan,
                                     DisaggregatedInstance, rank_params, rank_place)
from repro_torch.core.transport import HOP_KINDS, TRANSPORTS, make_transport
from repro_torch.launch.mesh import ServingRoles
from repro_torch.models.transformer import init_params
from repro_torch.serving.config import (DTYPES, KV_LAYOUTS, RUNTIMES,
                                        TRANSFERS, ServingConfig)
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.prefill import PrefillWorker


def format_stages(report: dict, iters: int) -> str:
    """The stage report's line: each stage's seconds and count, the
    per-op T_a / T_e / T_c, and each hop's stream stall per decode
    iteration of the ``iters`` the report covers."""
    per_stage = " ".join(f"{s}={report[f'{s}_s'] * 1e3:.3f}ms/{report[f'{s}_n']}"
                         for s in STAGES)
    waits = " ".join(f"{w}={report[f'{w}_s'] * 1e3 / max(1, iters):.3f}ms"
                     for w in WAITS)
    return (f"stages: {per_stage} | per-op t_a={report['t_a'] * 1e6:.1f}us "
            f"t_e={report['t_e'] * 1e6:.1f}us t_c={report['t_c'] * 1e6:.1f}us "
            f"| per-iteration {waits}")


def format_phases(ph: dict) -> str:
    return (f"phases: prefill={ph['prefill_s'] * 1e3:.1f}ms/{ph['prefills']} "
            f"transfer[{ph['transfer_mode']}]={ph['transfer_s'] * 1e3:.1f}ms/"
            f"{ph['transfer_n']} "
            f"decode={ph['decode_s'] * 1e3:.1f}ms/{ph['decode_n']}")


def format_pages(stats: dict) -> str:
    kp = stats["kv_pages"]
    line = (f"kv[paged]: {kp['used']}/{kp['n_pages']} pages of "
            f"{kp['page_size']} (high-water {kp['high_water']}, "
            f"{kp['allocs']} allocs, {kp['forks']} COW forks)")
    if "prefix_cache" in stats:
        px = stats["prefix_cache"]
        line += (f" | prefix: {px['hits']} hits / {px['misses']} misses "
                 f"({px['hit_tokens']} tokens reused, {px['evictions']} "
                 f"evicted)")
    return line


def format_transport(tr: dict) -> str:
    parts = []
    for kind in HOP_KINDS:
        h = tr.get(kind)
        if h and h["hops"]:
            p = f"{kind}={h['bytes'] / 1e6:.3f}MB/{h['hops']}"
            if h["sim_s"]:
                p += f"~{h['sim_s'] * 1e3:.2f}ms"
            parts.append(p)
    return f"transport[{tr['backend']}]: " + (" ".join(parts) or "no hops")


def format_experts(stats: dict) -> str:
    costs = " ".join(f"{c:.0f}" for c in stats["expert_node_cost"])
    return (f"experts: imbalance={stats['imbalance']:.2f} node-cost=[{costs}] "
            f"rebalances={stats['rebalances']} "
            f"replicated={stats['replicated_experts']}")


def zipf_router_bias(n_experts: int, alpha: float,
                     scale: float = 1.5) -> torch.Tensor:
    """A (E,) f32 router-logit bias that skews expert selection toward
    the low-index experts along a zipf(alpha) popularity curve: the
    controlled stand-in for the routing skew the §6 load balancer
    absorbs (centered log-popularity, ``scale`` logit standard
    deviations)."""
    ranks = np.arange(1, n_experts + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    bias = np.log(p)
    bias = (bias - bias.mean()) * scale / max(1e-9, bias.std())
    return torch.from_numpy(bias.astype(np.float32))


def inject_router_bias(params: dict, cfg, bias: torch.Tensor) -> dict:
    """Attach ``bias`` as ``router_bias`` to every MoE layer of
    ``params`` in place (the serving paths read it beside ``router``)."""
    n = 0
    for lp in params["layers"]:
        if "router" in lp:
            lp["router_bias"] = bias.to(lp["router"].device, torch.float32)
            n += 1
    if not n:
        raise ValueError(f"{cfg.name} has no MoE router to bias")
    return params


def build(sc: ServingConfig):
    """(model config, engine) for one serving config.  With ``multi``
    across ranks, this rank's engine over the parameters its role keeps
    (``draw_for_rank``)."""
    cfg = get_config(sc.arch)
    if sc.use_reduced:
        cfg = reduced(cfg)
    if sc.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=sc.n_layers)
    if sc.zipf_route_bias > 0.0 and cfg.moe is None:
        raise ValueError("--zipf-route-bias needs an MoE arch")
    # one ledger for every hop of the run: M2N / N2M, KV, weights
    transport = make_transport(sc.transport, **(
        {"device": sc.device} if sc.transport == "multi" else {}))
    if getattr(transport, "process_count", 1) > 1:
        transport.setup_serving(ServingRoles(transport.process_count,
                                             sc.prefill_devices))
        params = draw_for_rank(sc, cfg, transport)
    else:
        params = draw_params(sc, cfg, sc.device)
    return cfg, engine_for(sc, cfg, params, transport)


def draw_params(sc: ServingConfig, cfg, device, place=None) -> dict:
    """The model's weights from ``sc.seed`` (with the zipf router bias);
    ``place``: ``init_params``' (what the tree keeps of each leaf)."""
    params = init_params(cfg, sc.seed, getattr(torch, sc.dtype), device=device,
                         place=place)
    if sc.zipf_route_bias > 0.0:
        inject_router_bias(params, cfg,
                           zipf_router_bias(cfg.moe.n_experts,
                                            sc.zipf_route_bias))
    return params


def draw_for_rank(sc: ServingConfig, cfg, transport) -> dict:
    """This rank's parameters (``core.disagg.rank_params``), each leaf cut
    to what the rank's role keeps as soon as it is drawn
    (``core.disagg.rank_place``), so only a rank that keeps the whole
    model holds it whole.  The values are the seed's."""
    me = transport.process_index
    kw = dict(use_m2n=sc.use_m2n, inline_prefill=not sc.prefill_devices)
    params = draw_params(sc, cfg, transport.device or sc.device,
                         place=rank_place(cfg, transport.roles, me, **kw))
    return rank_params(cfg, params, transport.roles, me, **kw)


def engine_for(sc: ServingConfig, cfg, params: dict, transport=None) -> Engine:
    """The engine of ``sc`` over ``params``: the disaggregated runtime
    (``disagg`` / ``pingpong``; with ``microbatches="auto"`` its m is
    chosen from one profiled decode iteration first), the prefill worker
    with ``prefill_devices``, and one transport ledger for all hops
    (``transport``, by default made from ``sc``; across ranks a
    ``MultiControllerTransport`` after ``setup_serving``)."""
    if sc.expert_rebalance_every and sc.runtime == "monolithic":
        raise ValueError("--expert-rebalance-every needs --runtime "
                         "disagg|pingpong")
    if transport is None:
        transport = make_transport(sc.transport)
    roles = getattr(transport, "roles", None)
    rank = transport.process_index if roles is not None else 0
    say = print if sc.verbose and rank == 0 else (lambda *a, **k: None)
    runtime = None
    if sc.runtime in ("disagg", "pingpong"):
        auto = sc.microbatches == "auto"
        m = (max(2, len(roles.attn)) if roles is not None else 2) if auto \
            else sc.microbatches
        runtime = DisaggregatedInstance(
            cfg, params, plan=DisaggPlan(n_microbatches=m, use_m2n=sc.use_m2n,
                                         profile_stages=sc.profile_stages),
            expert_nodes=sc.expert_nodes, transport=transport)
        if auto:
            # T_a / T_e / T_c of one profiled decode iteration, then the
            # paper's m >= 2 (1 + T_c / T_f) feasibility bound; across
            # ranks the decode ranks measure, and the first attention
            # rank's m goes to every rank
            if runtime.role != "prefill":
                m = runtime.auto_microbatches(sc.max_batch, max_m=sc.max_batch)
            if roles is not None:
                m = transport.broadcast_ints([m], root=roles.attn[0], n=1)[0]
                m = max(m, len(roles.attn))
            runtime.plan.n_microbatches = m
            say(f"auto-selected m={m} micro-batches")
    worker = None
    if sc.prefill_devices:
        if roles is not None:
            stages = (f"{len(roles.attn)} attention + {len(roles.expert)} expert"
                      if roles.disjoint else "attention and experts on one rank")
            say(f"prefill cluster: {len(roles.prefill)} rank(s), decode cluster: "
                f"{len(roles.decode)} rank(s) ({stages}; "
                f"{'disjoint' if roles.separate_prefill else 'overlapping'})")
        else:
            # one card: the prefill cluster is a stream of the decode
            # side's device (the JAX launcher's single-device fallback)
            say("prefill cluster: 1 device(s), decode cluster: 1 device(s) "
                "(overlapping, single-device fallback)")
        worker = PrefillWorker(
            cfg, params, max_seq=sc.max_seq,
            chunk_tokens=sc.prefill_chunk_tokens,
            page_size=sc.page_size if sc.kv_layout == "paged" else 0,
            device=runtime.device if runtime is not None else None,
            ranks=roles.prefill if roles is not None else (), rank=rank)
    return Engine(cfg, params, config=sc, runtime=runtime, transport=transport,
                  prefill_worker=worker)


def prompt_maker(sc: ServingConfig, vocab: int, rng):
    """``make_prompt(plen)`` for the workload: with ``shared_prefix_len``
    every prompt opens with the same tokens (the shared-system-prompt
    pattern the radix prefix cache deduplicates), drawn first from
    ``rng``, followed by a per-request random tail."""
    shared = (rng.randint(2, vocab, size=sc.shared_prefix_len).tolist()
              if sc.shared_prefix_len else [])

    def make_prompt(plen: int) -> list:
        if shared:
            if plen <= len(shared):
                raise ValueError(f"prompt_len {plen} must exceed "
                                 f"shared_prefix_len {len(shared)}")
            return shared + rng.randint(2, vocab,
                                        size=plen - len(shared)).tolist()
        return rng.randint(2, vocab, size=plen).tolist()
    return make_prompt


def since(now: dict, before: dict):
    """Take ``before``'s cumulative phase counters (``transfer_mode`` and
    ``prefill_devices`` are not counters), hop counters per kind and
    kernel launches from ``now``'s, in place."""
    for k in ("prefill_s", "prefills", "prefill_batches", "prefill_tokens",
              "transfer_s", "transfer_n", "decode_s", "decode_n"):
        if k in now["phases"]:
            now["phases"][k] -= before["phases"][k]
    for kind, hop in now["transport"].items():
        if isinstance(hop, dict) and kind in before["transport"]:
            for k in hop:
                hop[k] -= before["transport"][kind].get(k, 0)
    now["kernel_launches"] = {k: v - before["kernel_launches"][k]
                              for k, v in now["kernel_launches"].items()}


def run(config: Optional[ServingConfig] = None, **overrides) -> dict:
    """Serve one workload; returns the engine's stats for the measured
    requests (``warmup_requests`` are served first and left out)."""
    sc = (ServingConfig(**overrides) if config is None
          else config.with_overrides(**overrides))
    cfg, eng = build(sc)
    rng = np.random.RandomState(sc.seed)
    make_prompt = prompt_maker(sc, cfg.vocab, rng)
    for i in range(sc.warmup_requests):
        eng.submit(Request(rid=-1 - i, prompt=make_prompt(sc.prompt_len or 8),
                           max_new_tokens=2))
    eng.run_until_done()
    pre = eng.stats()
    for i in range(sc.n_requests):
        plen = sc.prompt_len or int(rng.randint(2, sc.max_seq // 4))
        eng.submit(Request(rid=i, prompt=make_prompt(plen),
                           max_new_tokens=sc.max_new))
    if eng.runtime is not None:
        eng.runtime.reset_stage_times()
    t0 = time.perf_counter()
    eng.run_until_done()
    dt = time.perf_counter() - t0
    stats = eng.stats()
    for k in ("tokens", "decode_iters", "prefills", "finished"):
        stats[k] -= pre[k]
    # the phase, hop and launch counters of the run and of each rank
    for now, before in [(stats, pre)] + list(zip(stats.get("ranks", ()),
                                                 pre.get("ranks", ()))):
        since(now, before)
    # prefix-cache and page counters are cumulative too (warm-up may seed
    # the radix tree; only the measured requests' hits count)
    if "prefix_cache" in stats:
        px = stats["prefix_cache"]
        for k in ("hits", "misses", "hit_tokens", "evictions", "inserts"):
            px[k] -= pre["prefix_cache"][k]
        tot = px["hits"] + px["misses"]
        px["hit_rate"] = px["hits"] / tot if tot else 0.0
    if "kv_pages" in stats:
        for k in ("allocs", "forks", "released"):
            stats["kv_pages"][k] -= pre["kv_pages"][k]
    for k in ("rebalances", "placement_updates", "rebalance_s"):
        if k in stats:
            stats[k] -= pre[k]
    stats["wall_s"] = dt
    # serve rate counts prefill and the first tokens it samples; decode
    # rate counts only tokens of decode iterations over their host time
    stats["serve_tok_per_s"] = stats["tokens"] / dt
    stats["decode_tok_per_s"] = ((stats["tokens"] - stats["prefills"])
                                 / max(stats["phases"]["decode_s"], 1e-9))
    if sc.verbose and eng.rank == 0:
        print(f"{cfg.name} x{cfg.n_layers} layers {sc.dtype} [{sc.runtime}"
              f"{'+disagg-prefill' if sc.prefill_devices else ''}] on "
              f"{stats['device']}: served {stats['finished']} requests, "
              f"{stats['tokens']} tokens in {dt:.3f}s "
              f"({stats['serve_tok_per_s']:.2f} tok/s served, "
              f"{stats['decode_tok_per_s']:.2f} tok/s decoding, "
              f"{stats['decode_iters']} decode iters)")
        print(format_phases(stats["phases"]))
        print(format_transport(stats["transport"]))
        if "kv_pages" in stats:
            print(format_pages(stats))
        if "stages" in stats:
            print(format_stages(stats["stages"], stats["decode_iters"]))
        if "imbalance" in stats:
            print(format_experts(stats))
        print("kernel launches: " + " ".join(
            f"{k}={v}" for k, v in sorted(stats["kernel_launches"].items())))
        for r in stats.get("ranks", ()):
            print(format_rank(r))
    return stats


def format_rank(r: dict) -> str:
    """One rank of a run across ranks: role, decode host time per
    iteration, its hops (sent bytes / hops, and its waits), parameter
    bytes on its device and peak device memory."""
    ph = r["phases"]
    hops = " ".join(
        f"{k}={h['bytes'] / 1e6:.3f}MB/{h['hops']}"
        + (f" wait={h['wait_s'] * 1e3:.1f}ms/{h['waits']}" if "wait_s" in h else "")
        for k, h in r["transport"].items() if isinstance(h, dict))
    return (f"rank {r['rank']} [{r['role']}]: "
            f"{ph['decode_s'] * 1e3 / max(1, ph['decode_n']):.2f} ms/iter, "
            f"params {r['params_bytes'] / 1e9:.3f} GB, peak "
            f"{r['peak_bytes'] / 1e9:.3f} GB | {hops or 'no hops'}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the model to this many layers (0 = full depth)")
    ap.add_argument("--dtype", default="float32", choices=DTYPES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain torch path")
    ap.add_argument("--runtime", default="monolithic", choices=RUNTIMES)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--microbatches", default="3",
                    help="micro-batch count, or 'auto' to pick m from "
                         "measured T_a/T_e/T_c (paper eq. 3)")
    ap.add_argument("--use-m2n", action="store_true",
                    help="route MoE layers through the M2N dispatch "
                         "(core.m2n) over --expert-nodes shards on the "
                         "expert stream")
    ap.add_argument("--prefill-devices", type=int, default=0,
                    help="prefill on the prefill worker (N >= 1; on one card "
                         "a stream of its own on the decode side's device) "
                         "and move each request's KV into the decode cache "
                         "at admission (0 = inline prefill)")
    ap.add_argument("--transfer", default="async", choices=TRANSFERS,
                    help="KV migration: async = only the decode stream waits "
                         "for the KV, sync = the host waits per row or page")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=512,
                    help="token budget of one batched prefill call")
    ap.add_argument("--profile-stages", action="store_true",
                    help="wait for each stage as it is issued, so the stage "
                         "times are each stage's device time alone "
                         "(serialises the pipeline)")
    ap.add_argument("--expert-nodes", type=int, default=1,
                    help="expert nodes the placement and the m2n dispatch "
                         "are solved for (all on this one device)")
    ap.add_argument("--expert-rebalance-every", type=int, default=0,
                    help="re-solve the expert placement from live routing "
                         "counts every N decode iterations (0 = static "
                         "contiguous placement; needs --runtime "
                         "disagg|pingpong)")
    ap.add_argument("--expert-replication",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="let hot experts be replicated across expert "
                         "nodes when rebalancing (paper §6)")
    ap.add_argument("--zipf-route-bias", type=float, default=0.0,
                    help="inject a zipf(alpha) router-logit bias to skew "
                         "expert traffic (0 = off)")
    ap.add_argument("--transport", default="inproc", choices=sorted(TRANSPORTS),
                    help="hop ledger: inproc = the stream hop, simrdma = the "
                         "same plus a per-hop RDMA cost model, multi = across "
                         "the REPRO_* ranks (in one process: inproc)")
    ap.add_argument("--kv-layout", default="contiguous", choices=KV_LAYOUTS,
                    help="KV-cache layout: contiguous = one (B, W) ring-"
                         "buffer row per request; paged = block tables "
                         "over a refcounted fixed-size page pool with "
                         "radix prefix reuse")
    ap.add_argument("--page-size", type=int, default=16,
                    help="token slots per KV page (paged layout; must "
                         "divide --max-seq)")
    ap.add_argument("--kv-pool-pages", type=int, default=0,
                    help="page-pool size (0 = auto from max_batch/max_seq)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix prefix cache over the page pool (paged "
                         "layout only)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="workload: every prompt opens with the same N "
                         "tokens (0 = fully random prompts)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="pin every prompt to this length (0 = random)")
    ap.add_argument("--warmup-requests", type=int, default=0)
    run(config=ServingConfig.from_args(ap.parse_args()))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
