"""The control of the check: the reference computed one precision below
the configuration's (float8 e4m3 matrix products), put where the program
serves, has to come out not correct by the comparison that decides a
run's ``correct`` (``harness.check.verdict`` over the cell's limits).

On the CPU at a tiny size the control's mean gap reads far above a
float32 program's (float32 rounding: no served token off the reference's
best); the tiny model reads 0.029-0.081 on these seeds, so 0.02 is the
line.  On the card, marked ``cuda``, at each cell's own size on three
seeds, the control fails the cell's limit and the program passes it."""
import json

import portbench_tiny
import pytest
from control import one_seed  # noqa: E402
from harness.check import verdict
from harness.spec import Cell, load_benchmark

SEEDS = (1, 2, 3)


@pytest.mark.parametrize("config", [portbench_tiny.MIXTRAL, portbench_tiny.ARCTIC],
                         ids=lambda c: c["name"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_reads_far_above_the_program_at_a_tiny_size(config, seed):
    cell = portbench_tiny.cell(dict(config, torch_dtype="float32"), limit=0.02)
    row = one_seed(cell, seed, 1.0, "cpu")
    assert row["program"]["max_logit_gap"] < 1e-4
    assert row["control"]["mean_logit_gap"] > 0.02, row
    assert row["control"]["share_off_best"] > 0.1, row
    limits = cell.check["limits"]
    assert verdict(row["program"], limits) and not verdict(row["control"], limits), row
    assert row["program_verdict"] and not row["control_verdict"] and row["correct"], row


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mixtral-8L-chat", "arctic-2L-chat"])
def test_control_fails_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell runs at its published widths")
    bench = load_benchmark(portbench_tiny.ROOT)
    cell = Cell(bench, workload, portbench_tiny.ROOT)
    limits = cell.check["limits"]
    for seed in SEEDS:
        row = one_seed(cell, seed, bench["run_seconds"], "cuda")
        print(json.dumps(row), flush=True)
        assert not verdict(row["control"], limits), row
        assert verdict(row["program"], limits) and row["correct"], row
