"""The port's model registry and deployment planner against the JAX
package, on the CPU.

Configs: every registered name carries the same fields
(``dataclasses.asdict``), the same analytic parameter counts and the
same ``reduced`` variant in both packages; ``ASSIGNED`` and ``PAPER``
are equal.  Planner (paper §4.2 Algorithm 1, §4.3): the port's copy of
``core/planner.py`` is pure Python over the same formulas, so every
plan must be the JAX plan: integers equal and floats equal to 1e-12
relative, for every config and every ordered pair of the six GPU rows
of the paper's Table 3.  The cases of ``tests/test_core.py``'s planner
class hold on the port too.
"""
import dataclasses
import math

import pytest

from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.core import pingpong as tpp
from repro_torch.core import planner as tplanner

NAMES = tconfig.list_configs()
GPU_ROWS = ["L20", "H800", "A800", "A100", "H20", "L40S"]
REL = 1e-12


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro import config as jconfig
    from repro import configs as jconfigs
    from repro.core import planner as jplanner
    return jconfig, jconfigs, jplanner


def test_registry_names_match_jax(jx):
    jconfig, jconfigs, _ = jx
    assert NAMES == jconfig.list_configs()
    assert len(NAMES) == 13
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert tconfigs.PAPER == jconfigs.PAPER
    assert sorted(tconfigs.ASSIGNED + tconfigs.PAPER) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_jax(jx, name):
    jconfig = jx[0]
    tc, jc = tconfig.get_config(name), jconfig.get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.has_cross == jc.has_cross
    assert tc.n_blocks == jc.n_blocks
    assert tc.resolved_head_dim == jc.resolved_head_dim
    assert (dataclasses.asdict(tconfig.reduced(tc))
            == dataclasses.asdict(jconfig.reduced(jc)))
    if tc.ssm is not None:
        assert tc.ssm.d_inner(tc.d_model) == jc.ssm.d_inner(jc.d_model)
        assert tc.ssm.n_heads(tc.d_model) == jc.ssm.n_heads(jc.d_model)


def test_shape_config_matches_jax(jx):
    jconfig = jx[0]
    want = jconfig.INPUT_SHAPES["decode_32k"]
    got = tconfig.ShapeConfig(**dataclasses.asdict(want))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ([f.name for f in dataclasses.fields(tconfig.ShapeConfig)]
            == [f.name for f in dataclasses.fields(jconfig.ShapeConfig)])


def test_hardware_rows_are_the_papers_gpus(jx):
    jplanner = jx[2]
    assert list(tplanner.HARDWARE) == GPU_ROWS
    for name, hw in tplanner.HARDWARE.items():
        assert dataclasses.asdict(hw) == dataclasses.asdict(jplanner.HARDWARE[name])
    assert tplanner.BYTES == jplanner.BYTES


def _both(f_port, f_jax):
    """Call both; equal plans, or the same exception type from both (the
    planner divides by the expert FFN time, which is 0 for a model with
    no FFN such as mamba2-1.3b, in either package)."""
    try:
        want = f_jax()
    except Exception as e:           # noqa: BLE001
        with pytest.raises(type(e)):
            f_port()
        return None
    got = f_port()
    _same(got, want)
    return got


def _same(a, b):
    """Plans (or None) equal: ints and strings exactly, floats to REL."""
    if a is None or b is None:
        assert a is None and b is None
        return
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k, v in da.items():
        if isinstance(v, float):
            assert math.isclose(v, db[k], rel_tol=REL, abs_tol=0.0), (k, v, db[k])
        else:
            assert v == db[k], (k, v, db[k])
    assert a.summary() == b.summary()


@pytest.mark.parametrize("name", NAMES)
def test_search_plan_matches_jax_on_every_pair(jx, name):
    jconfig, _, jplanner = jx
    tc, jc = tconfig.get_config(name), jconfig.get_config(name)
    found = 0
    for ha in GPU_ROWS:
        for he in GPU_ROWS:
            got = _both(lambda: tplanner.search_plan(tc, hw_attn=ha, hw_expert=he),
                        lambda: jplanner.search_plan(jc, hw_attn=ha, hw_expert=he))
            found += got is not None
    # the performance-model pieces at one operating point
    hw_a, hw_e = tplanner.HARDWARE["H20"], tplanner.HARDWARE["L40S"]
    jhw_a, jhw_e = jplanner.HARDWARE["H20"], jplanner.HARDWARE["L40S"]
    for tp in (1, 2, 8):
        assert tplanner.attn_time(tc, 37.5, 730.0, hw_a, tp) == \
            jplanner.attn_time(jc, 37.5, 730.0, jhw_a, tp)
        assert tplanner.expert_time(tc, 12.25, hw_e, tp) == \
            jplanner.expert_time(jc, 12.25, jhw_e, tp)
        assert tplanner.comm_time(tc, 37.5, 12.25, hw_a, hw_e, tp, tp) == \
            jplanner.comm_time(jc, 37.5, 12.25, jhw_a, jhw_e, tp, tp)
        assert tplanner.max_batch_for_memory(tc, hw_a, tp, 3, 3, 730.0) == \
            jplanner.max_batch_for_memory(jc, jhw_a, tp, 3, 3, 730.0)
    assert tplanner.attn_param_bytes(tc) == jplanner.attn_param_bytes(jc)
    assert tplanner.expert_param_bytes(tc) == jplanner.expert_param_bytes(jc)
    assert tplanner.kv_bytes_per_token(tc) == jplanner.kv_bytes_per_token(jc)
    if tc.moe is not None and tc.param_count() < 4e11:
        assert found > 0


@pytest.mark.parametrize("name", NAMES)
def test_search_heterogeneous_matches_jax(jx, name):
    jconfig, _, jplanner = jx
    tc, jc = tconfig.get_config(name), jconfig.get_config(name)
    _both(lambda: tplanner.search_heterogeneous(tc),
          lambda: jplanner.search_heterogeneous(jc))
    kw = dict(candidates=["H20", "L40S"], slo_s=0.2, seq_len=512.0)
    _both(lambda: tplanner.search_heterogeneous(tc, **kw),
          lambda: jplanner.search_heterogeneous(jc, **kw))


# the cases of tests/test_core.py::TestPlanner, on the port
def test_roofline_knee_batch():
    hw = tplanner.HARDWARE["A100"]
    knee = hw.tflops * 1e12 / (hw.hbm_gbps * 1e9)
    assert 150 < knee < 160


def test_search_finds_plan_mixtral():
    cfg = tconfig.get_config("mixtral-8x22b")
    plan = tplanner.search_plan(cfg, hw_attn="A100", slo_s=0.150)
    assert plan is not None
    cond = tpp.conditions_met(plan.t_a, plan.t_e, plan.t_c, plan.m,
                              balance_tol=0.35)
    assert cond["comm_hidden"] and cond["pipeline_full"], plan.summary()
    assert plan.t_iter <= 0.150 + 1e-9
    assert plan.m >= 3


def test_expert_batch_aggregation():
    cfg = tconfig.get_config("mixtral-8x22b")
    plan = tplanner.search_plan(cfg, hw_attn="A100", slo_s=0.150)
    b_e = plan.global_batch * cfg.moe.top_k / (plan.m * cfg.moe.n_experts)
    hw = tplanner.HARDWARE["A100"]
    knee = hw.tflops * 1e12 / (hw.hbm_gbps * 1e9)
    assert b_e > 0.8 * knee, f"b_e={b_e}, knee={knee}"


def test_heterogeneous_beats_homogeneous_per_cost():
    cfg = tconfig.get_config("mixtral-8x22b")
    het = tplanner.search_heterogeneous(cfg, candidates=["H20", "L40S"])
    homo = tplanner.search_plan(cfg, hw_attn="H20", hw_expert="H20")
    assert het.tpd > homo.tpd
    assert het.hw_attn == "H20" and het.hw_expert == "L40S"
