"""The port's spans (``repro_torch.trace``) and the ping-pong runtime's
stream stalls at each hop, on the CPU; one case on the card.

  * with no profiler recording ``span`` is the shared no-op;
  * under ``torch.profiler`` one step of a tiny ping-pong MoE engine
    (``tests/_torch_disagg.py``'s engine shape and prompts) opens every
    span of ``SPANS`` but the card's ``runtime.capture`` and nests them:
    ``engine.step`` holds ``engine.admit``, which holds each request's
    ``model.prefill`` (one ``model.prefill.layer`` a layer, each holding
    its attention and FFN sublayers, the FFN its ``model.moe.combine``)
    and KV insert, and
    ``engine.decode.issue``, which holds every ``runtime.*`` span, L·m
    of each;
  * the tokens are the same with the profiler recording and without;
  * ``stage_report()``'s ``m2n_wait_s`` / ``n2m_wait_s`` are 0.0 on the
    CPU, where a hop is no stream wait;
  * on the card the attention stream stalls on the expert stream where
    the expert stage is the longer, and the expert stream's compute and
    stalls fit in the wall time.
"""
import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_disagg as td
from repro_torch import trace
from repro_torch.config import get_config, reduced
from repro_torch.core.disagg import DisaggPlan, DisaggregatedInstance
from repro_torch.launch.serve import engine_for
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Request

torch.set_num_threads(1)

M = 2
RUNTIME = ("runtime.attn", "runtime.expert", "runtime.combine", "runtime.m2n",
           "runtime.n2m")


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_config("mixtral-8x22b"))
    return cfg, init_params(cfg, seed=0, device="cpu")


def engine(tiny):
    """The ping-pong engine, rebalancing every decode iteration, with
    one request a KV row."""
    cfg, params = tiny
    sc = ServingConfig(device="cpu", runtime="pingpong", microbatches=M,
                       expert_rebalance_every=1, verbose=False, **td.ENGINE)
    eng = engine_for(sc, cfg, params)
    for i, p in enumerate(td.prompts(n=td.ENGINE["max_batch"])):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    return eng


def spans(prof):
    """The port's spans a profile holds: [(name, start us, end us)]."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.split(".")[0] in ("engine", "model", "runtime")]


def inside(outer, got, name):
    """The spans ``name`` of ``got`` that lie inside the span ``outer``."""
    return [s for s in got if s[0] == name
            and outer[1] <= s[1] and s[2] <= outer[2]]


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("engine.step") is trace.span("model.prefill")
    with trace.span("engine.step") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(trace.span("engine.step"), torch.profiler.record_function)


def test_one_step_nests_the_spans(tiny):
    cfg, _ = tiny
    eng = engine(tiny)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    got = spans(prof)
    # the chains are captured into CUDA graphs on the card only
    assert {s[0] for s in got} == set(trace.SPANS) - {"runtime.capture"}
    [step] = [s for s in got if s[0] == "engine.step"]
    [admit] = inside(step, got, "engine.admit")
    [decode] = inside(step, got, "engine.decode.issue")
    assert admit[2] <= decode[1]
    assert len(inside(step, got, "engine.retire")) == 2
    assert len(inside(step, got, "engine.sample")) == 1
    assert len(inside(step, got, "engine.rebalance")) == 1
    n = td.ENGINE["max_batch"]
    assert len(inside(admit, got, "engine.admit.plan")) == 1
    assert len(inside(admit, got, "engine.admit.insert")) == n
    prefills = inside(admit, got, "model.prefill")
    assert len(prefills) == n
    for p in prefills:
        layers = inside(p, got, "model.prefill.layer")
        assert len(layers) == cfg.n_layers
        for layer in layers:
            [ffn] = inside(layer, got, "model.prefill.ffn")
            assert len(inside(layer, got, "model.prefill.attn")) == 1
            assert len(inside(ffn, got, "model.moe.combine")) == 1
    for name in RUNTIME:
        assert len(inside(decode, got, name)) == cfg.n_layers * M, name
        assert len([s for s in got if s[0] == name]) == cfg.n_layers * M, name
    for c in inside(decode, got, "runtime.combine"):
        assert len(inside(c, got, "model.moe.combine")) == 1


def test_tokens_are_the_same_under_the_profiler(tiny):
    plain = {r.rid: r.generated for r in engine(tiny).run_until_done()}
    eng = engine(tiny)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = {r.rid: r.generated for r in eng.run_until_done()}
    assert traced == plain
    st = eng.stats()["stages"]
    assert st["m2n_wait_s"] == st["n2m_wait_s"] == 0.0
    assert st["attn_n"] > 0


def test_combine_spans_cover_sixteen_experts_each():
    """40 experts: 3 ``model.moe.combine`` spans (16, 16 and 8
    scatter-adds), and the sum unchanged by the profiler."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    E, C, d, T = 40, 3, 8, 10
    out = torch.randn(E, C, d, generator=gen)
    idx = torch.randint(0, T + 1, (E, C), generator=gen).to(torch.int32)
    gates = torch.rand(E, C, generator=gen)
    want = moe.combine(out, idx, gates, T)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = moe.combine(out, idx, gates, T)
    assert torch.equal(got, want)
    n = [e.name for e in prof.events()].count("model.moe.combine")
    assert n == -(-E // moe.COMBINE_SPAN_EXPERTS) == 3


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_hop_stalls_on_the_card():
    """Mixtral's layer at d 2048 with 16 experts of 65536, whose 12.9 GB
    a layer the full-capacity dispatch streams in each micro-batch: the
    expert stage is the longer, so the attention stream waits at each
    N2M hop; each stream's stage and stall times sum to less than the
    wall time of the decode iterations they lie in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    small = reduced(get_config("mixtral-8x22b"), d_model=2048, n_heads=16)
    cfg = dataclasses.replace(small, moe=dataclasses.replace(
        small.moe, n_experts=16, d_ff_expert=65536))
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    inst = DisaggregatedInstance(cfg, params, DisaggPlan(M))
    B = 16
    cache = init_cache(cfg, B, 64, dtype=torch.bfloat16, device=dev)
    tokens = torch.arange(B, device=dev)
    pos = torch.full((B,), 3, dtype=torch.int32, device=dev)
    inst.decode_microbatched(tokens, cache, pos)             # warm-up
    torch.cuda.synchronize()
    inst.reset_stage_times()
    t0 = time.perf_counter()
    for _ in range(4):
        inst.decode_microbatched(tokens, cache, pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = inst.stage_report()
    assert rep["expert_s"] > rep["attn_s"] + rep["combine_s"], rep
    assert rep["n2m_wait_s"] > 0, rep
    assert rep["expert_s"] + rep["m2n_wait_s"] <= wall, (rep, wall)
    assert rep["attn_s"] + rep["combine_s"] + rep["n2m_wait_s"] <= wall, (rep, wall)
