"""The closed loop: the benchmark's clients in front of the port's engine.

The harness builds the engine with ``repro_torch.launch.serve.engine_for``
and drives it with ``Engine.submit`` and ``Engine.step`` alone.  Every
step ends in the sampled tokens' ``.tolist()``, which waits for the
device, so the host clock read after a step is when that step's tokens
exist: each request's token times come from it with no change to the
program.  A client sends its next request as soon as the harness sees
the previous one finished, so it is submitted between two steps and
admitted by the next.

Each step is a span of the benchmark's own: its start and end on the
host clock, the requests it admitted (with their prompt lengths) and,
for every row it decoded, the row's slot and its count of valid KV
positions after the step's write (the position the request reached).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from harness.traffic import Traffic


@dataclass
class Step:
    t0: float
    t1: float
    admitted: List[int]                 # prompt lengths of requests admitted
    rows: Dict[int, int]                # slot -> valid KV positions, decoded rows
    tokens: int                         # tokens the step emitted
    traced: bool = False                # inside the profiled stretch


@dataclass
class Flight:
    """One request as the harness sees it."""
    k: int
    prompt_len: int
    t_submit: float
    req: object                         # the engine's Request
    times: List[float] = field(default_factory=list)   # one per token
    slot: Optional[int] = None


def port_config(cfg_file: dict):
    """The port's ModelConfig of a configuration file: the registered
    architecture ``port_arch`` with the file's sizes put in."""
    from repro_torch.config import get_config
    cfg = get_config(cfg_file["port_arch"])
    moe = dataclasses.replace(
        cfg.moe, n_experts=cfg_file["num_local_experts"],
        top_k=cfg_file["num_experts_per_tok"],
        d_ff_expert=cfg_file["intermediate_size"],
        d_ff_dense_residual=cfg_file.get("dense_residual_size", 0))
    return dataclasses.replace(
        cfg, n_layers=cfg_file["num_hidden_layers"], d_model=cfg_file["hidden_size"],
        n_heads=cfg_file["num_attention_heads"],
        n_kv_heads=cfg_file["num_key_value_heads"], head_dim=cfg_file["head_dim"],
        vocab=cfg_file["vocab_size"], rope_theta=float(cfg_file["rope_theta"]),
        moe=moe)


def build_engine(cfg_file: dict, engine_spec: dict, params: dict, device: str):
    """The engine of the cell, greedy, as ``engine_for`` makes it."""
    from repro_torch.launch.serve import engine_for
    from repro_torch.serving.config import ServingConfig
    cfg = port_config(cfg_file)
    sc = ServingConfig(arch=cfg_file["port_arch"], use_reduced=False,
                       n_layers=cfg.n_layers, dtype=cfg_file["torch_dtype"],
                       device=device, runtime=engine_spec["runtime"],
                       microbatches=engine_spec["microbatches"],
                       kv_layout=engine_spec["kv_layout"],
                       max_batch=engine_spec["max_batch"],
                       max_seq=engine_spec["max_seq"], temperature=0.0,
                       verbose=False)
    return engine_for(sc, cfg, params), cfg


class ClosedLoop:
    """``clients`` clients, each with one request outstanding."""

    def __init__(self, engine, traffic: Traffic, clock=time.perf_counter):
        from repro_torch.serving.engine import Request
        self._Request = Request
        self.eng = engine
        self.traffic = traffic
        self.clock = clock
        self.next_k = 0
        self.flights: Dict[int, Flight] = {}     # k -> in flight
        self.done: List[Flight] = []
        self.steps: List[Step] = []
        self.before_step = None                  # hook (the traced run's)

    def submit(self):
        """One client sends its next request."""
        r = self.traffic.request(self.next_k)
        req = self._Request(rid=r.index, prompt=r.prompt,
                            max_new_tokens=r.max_new_tokens)
        self.flights[r.index] = Flight(k=r.index, prompt_len=len(r.prompt),
                                       t_submit=self.clock(), req=req)
        self.eng.submit(req)
        self.next_k += 1

    def start(self):
        """Every client sends its first request."""
        for _ in range(self.traffic.clients):
            self.submit()

    def step(self, traced: bool = False) -> Step:
        if self.before_step is not None:
            self.before_step(len(self.steps))
        seen = {k: len(f.req.generated) for k, f in self.flights.items()}
        t0 = self.clock()
        self.eng.step()
        t1 = self.clock()
        admitted, rows, tokens, finished = [], {}, 0, []
        for k, f in self.flights.items():
            new = len(f.req.generated) - seen[k]
            if not new:
                continue
            if seen[k] == 0:                   # admitted: first token by prefill
                admitted.append(f.prompt_len)
                f.slot = f.req.slot
            # the decode step wrote position prompt + generated - 2, so the
            # row holds that many + 1 valid positions
            rows[f.slot] = f.prompt_len + len(f.req.generated) - 1
            f.times += [t1] * new
            tokens += new
            if f.req.done:
                finished.append(k)
        for k in finished:
            self.done.append(self.flights.pop(k))
        st = Step(t0=t0, t1=t1, admitted=admitted, rows=rows, tokens=tokens,
                  traced=traced)
        self.steps.append(st)
        return st

    def refill(self):
        """Each client whose request finished sends its next one."""
        while len(self.flights) < self.traffic.clients:
            self.submit()


def window_records(loop: ClosedLoop, t_start: float, t_end: float):
    """(steps, flights) of the window [t_start, t_end]: the steps that
    ended in it, and every request with a token in it."""
    steps = [s for s in loop.steps if t_start < s.t1 <= t_end]
    flights = [f for f in loop.done + list(loop.flights.values())
               if f.times and f.times[-1] > t_start]
    return steps, flights


def positions_array(step: Step, max_batch: int) -> np.ndarray:
    out = np.zeros(max_batch, np.int64)
    for slot, v in step.rows.items():
        out[slot] = v
    return out
