"""The whole run, past the look for a card, on the CPU at a tiny size,
with the timed path broken underneath: ``correct`` has to come out
false for every fault a serving cell on one card can have, and true
without one.  The limit is the Mixtral cell's own; the tiny models run
in float32, whose own rounding reads ~1e-5, so that only the fault can
cross it (in bf16 a tiny model's router flips swing the widest gap).
``control.py --fault`` reads the same faults at a cell's own size."""
import faults
import portbench_tiny
import pytest
from harness.bench import measure
from harness.spec import PORTBENCH, load_json

LIMIT = load_json(PORTBENCH / "checks" / "mixtral-8L-chat.json")["limits"]["mean_logit_gap"]


@pytest.mark.parametrize("config", [portbench_tiny.MIXTRAL, portbench_tiny.ARCTIC],
                         ids=lambda c: c["name"])
@pytest.mark.parametrize("fault", (None,) + faults.NAMES)
def test_fault_fails_the_check(fault, config, monkeypatch):
    if fault is not None:
        owner, name, make = faults.targets()[fault]
        monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    cell = portbench_tiny.cell(dict(config, torch_dtype="float32"), limit=LIMIT)
    out = measure(cell, 11, 1.0, False, "cpu")
    gap = out["readings"]["mean_logit_gap"]
    if fault is None:
        assert out["correct"] and gap <= LIMIT, gap
    else:
        assert not out["correct"] and gap > LIMIT, gap
