"""The ping-pong decode's attention-stream chains replayed from CUDA
graphs (``repro_torch.core.graphs``).

  * the rule that decides how a step runs (``chain_spec`` and
    ``ChainCache``): a key's first step eager, its second a capture, then
    replays; CPU tensors, ranks, M2N and stage profiling always eager;
    a paged cache (a fresh view each step), changed slices, changed cache
    storage and a new placement warm up again and capture again;
  * on the CPU, the chains' stage functions run through a stand-in for
    the capture that re-runs them at each replay: the served tokens and
    every step's logits equal the eager path's bit for bit, and the ops a
    recorder patched onto ``kernels.ops`` sees (as ``portbench/work``
    patches them) are the same calls, each ``gating_dispatch`` with its
    own counts tensor;
  * on the card, with real CUDA graphs: the same, over 32 and more steps
    with admissions and retirements, at tiny Mixtral, Arctic, qwen2-moe
    and gemma2 shapes, with every attention-stream stage after the
    capture a replay.

This file imports nothing of JAX, so its ``cuda`` cases run on the card:
``pytest --noconftest -q tests/test_torch_graphs.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from repro_torch.config import get_config, reduced
from repro_torch.core import graphs
from repro_torch.core import load_balance as lb
from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
from repro_torch.kernels import ops
from repro_torch.launch.serve import engine_for
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Request

torch.set_num_threads(1)

ARCHS = ("mixtral-8x22b", "arctic-480b", "qwen2-moe-a2.7b", "gemma2-27b")
M = 2


@pytest.fixture(scope="module")
def mixtral():
    cfg = reduced(get_config("mixtral-8x22b"))
    return cfg, init_params(cfg, seed=0, device="cpu")


def _tensors(cache):
    return [t for entry in cache for t in entry.values()]


# ------------------------------------------------------------------- rule
def _steps(case, cfg, params):
    """(instance, [(spec, cache tensors) of each step]) of one case."""
    B = 4
    plan = DisaggPlan(M)
    mbs = [slice(0, 2), slice(2, 4)]
    cache = init_cache(cfg, B, 16, device="cpu")
    if case == "m2n":
        plan = DisaggPlan(M, use_m2n=True)
    if case == "profile":
        plan = DisaggPlan(M, profile_stages=True)
    inst = DisaggregatedInstance(cfg, params, plan, expert_nodes=2)
    if case == "ranks":
        # what a transport whose roles put attention and experts on
        # disjoint ranks sets
        inst.on_ranks = True
    keys = []
    for step in range(5):
        c, s = cache, mbs
        if case == "paged":
            # the paged layout gathers a fresh dense view every step
            c = [{k: v.clone() for k, v in e.items()} for e in cache]
        if case == "slices" and step >= 2:
            s = [slice(0, 1), slice(1, 4)]
        if case == "storage" and step == 2:
            c = cache = init_cache(cfg, B, 16, device="cpu")
        if case == "placement" and step == 2:
            loads = np.arange(1, cfg.moe.n_experts + 1, dtype=float)
            assert inst.apply_placement(lb.balance_experts(loads, 2))
        keys.append((inst.chain_spec(B, s, c), _tensors(c)))
    return inst, keys


RULE = {
    "same": ["eager", "capture", "replay", "replay", "replay"],
    "paged": ["eager"] * 5,
    "ranks": ["eager"] * 5,
    "m2n": ["eager"] * 5,
    "profile": ["eager"] * 5,
    "slices": ["eager", "capture", "eager", "capture", "replay"],
    "storage": ["eager", "capture", "eager", "capture", "replay"],
    "placement": ["eager", "capture", "eager", "capture", "replay"],
}


@pytest.mark.parametrize("case", list(RULE))
def test_the_rule_runs_eager_or_captures_again(mixtral, case):
    cfg, params = mixtral
    inst, keys = _steps(case, cfg, params)
    cc = graphs.ChainCache()
    got = []
    for spec, tensors in keys:
        a = cc.action(spec, tensors)
        if a == "capture":
            cc.install(object())
        got.append(a)
    assert got == RULE[case]
    if inst.on_ranks:
        return
    # on the CPU every step runs eager: the counters stay 0
    tokens = torch.zeros(4, dtype=torch.int64)
    pos = torch.zeros(4, dtype=torch.int32)
    cache = init_cache(cfg, 4, 16, device="cpu")
    for _ in range(3):
        inst.decode_microbatched(tokens, cache, pos)
    rep = inst.stage_report()
    assert rep["attn_n"] == 3 * M * cfg.n_layers
    assert rep["graphed_n"] == 0 and rep["captures"] == 0
    assert inst._chain_cache.chains is None


# ------------------------------------------------------- chains vs eager
class _Replay:
    """A stand-in for a captured graph: replay re-runs the chain."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args

    def replay(self):
        self.fn(*self.args)


class _Recorder:
    """``portbench/work``'s patching of ``kernels.ops``: every call, and
    each ``gating_dispatch``'s counts tensor by reference."""

    def __init__(self, monkeypatch):
        self.log, self.counts = [], []
        for name in ("gating_dispatch", "grouped_matmul", "decode_attention"):
            monkeypatch.setattr(ops, name, self._wrap(name, getattr(ops, name)))

    def _wrap(self, name, orig):
        def call(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.log.append((name, tuple(args[0].shape)))
            if name == "gating_dispatch":
                self.counts.append(out[2])
            return out
        return call


def _family(arch, dtype, device):
    cfg = reduced(get_config(arch))
    return cfg, init_params(cfg, seed=0, dtype=dtype, device=device)


def _serve(cfg, params, device, dtype, graphed, monkeypatch, rebalance=False):
    """Serve 8 requests over 4 KV rows (admissions while others decode,
    retirements at 9-30 new tokens) through the ping-pong engine; the
    runtime's chains on (``graphed``) or off.  Returns (tokens by
    request, each decode step's logits on the CPU, the stage report,
    the recorder's log per decode step, the counts it kept)."""
    sc = ServingConfig(device=device, dtype=dtype, runtime="pingpong",
                       microbatches=M, max_batch=4, max_seq=64, verbose=False,
                       expert_nodes=2 if rebalance else 1,
                       expert_rebalance_every=5 if rebalance else 0)
    eng = engine_for(sc, cfg, params)
    rt = eng.runtime
    if device == "cpu" and graphed:
        # the chains on the CPU: a capture records each chain, a replay
        # re-runs it
        monkeypatch.setattr(graphs, "cuda_capture",
                            lambda device: (lambda fn, *a: _Replay(fn, a)))
        rt._chains_for = rt._chains_lookup
    elif not graphed:
        rt._chains_for = lambda *a: None
    rec = _Recorder(monkeypatch)
    logits, calls = [], []
    decode = rt.decode_microbatched

    def recorded(*args, **kwargs):
        n = len(rec.log)
        out = decode(*args, **kwargs)
        logits.append(out[0].to("cpu", copy=True))
        calls.append(rec.log[n:])
        return out

    rt.decode_microbatched = recorded
    rng = np.random.RandomState(3)
    for i, n in enumerate((12, 20, 9, 30, 15, 24, 11, 18)):
        prompt = rng.randint(2, cfg.vocab, size=rng.randint(2, 9)).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=n))
    done = {r.rid: r.generated for r in eng.run_until_done()}
    monkeypatch.undo()
    return done, logits, rt.stage_report(), calls, rec.counts


def _same_serving(a, b, graphed_rep):
    (tok_a, log_a, _, calls_a, cnt_a), (tok_b, log_b, rep_b, calls_b, cnt_b) = a, b
    assert tok_b == tok_a
    assert len(log_b) == len(log_a) >= 32
    for x, y in zip(log_a, log_b):
        assert torch.equal(x, y)
    assert calls_b == calls_a
    assert len({c.data_ptr() for c in cnt_b}) == len(cnt_b) == len(cnt_a)
    for x, y in zip(cnt_a, cnt_b):
        assert torch.equal(x.cpu(), y.cpu())
    graphed_rep(rep_b)


@pytest.mark.parametrize("arch", ARCHS)
def test_chains_serve_the_eager_tokens_on_the_cpu(arch, monkeypatch):
    cfg, params = _family(arch, torch.float32, "cpu")
    eager = _serve(cfg, params, "cpu", "float32", False, monkeypatch)
    chained = _serve(cfg, params, "cpu", "float32", True, monkeypatch)

    def check(rep):
        # one warm-up step, then every attention-stream stage a replay
        L = cfg.n_layers
        assert rep["captures"] == 1
        assert rep["graphed_n"] == rep["attn_n"] + rep["combine_n"] - 2 * M * L
    _same_serving(eager, chained, check)


def test_chains_capture_again_after_a_placement_on_the_cpu(mixtral, monkeypatch):
    cfg, params = mixtral
    eager = _serve(cfg, params, "cpu", "float32", False, monkeypatch, rebalance=True)
    chained = _serve(cfg, params, "cpu", "float32", True, monkeypatch, rebalance=True)
    _same_serving(eager, chained, _captured_again)


def _captured_again(rep):
    assert rep["captures"] >= 2 and rep["graphed_n"] > 0


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_chains_serve_the_eager_tokens_on_the_card(arch, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, params = _family(arch, torch.bfloat16, "cuda")
    eager = _serve(cfg, params, "cuda", "bfloat16", False, monkeypatch)
    chained = _serve(cfg, params, "cuda", "bfloat16", True, monkeypatch)

    def check(rep):
        L = cfg.n_layers
        assert rep["captures"] == 1
        assert rep["graphed_n"] == rep["attn_n"] + rep["combine_n"] - 2 * M * L
    _same_serving(eager, chained, check)


@pytest.mark.cuda
def test_chains_capture_again_after_a_placement_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, params = _family("mixtral-8x22b", torch.bfloat16, "cuda")
    eager = _serve(cfg, params, "cuda", "bfloat16", False, monkeypatch, rebalance=True)
    chained = _serve(cfg, params, "cuda", "bfloat16", True, monkeypatch, rebalance=True)
    _same_serving(eager, chained, _captured_again)
