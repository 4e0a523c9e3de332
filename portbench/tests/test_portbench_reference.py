"""The plain reference against the port's plain CPU path, and the
benchmark's weights: drawn again leaf by leaf, bit for bit."""
import portbench_tiny
import pytest
import torch
from harness.bench import measure
from harness.serve import port_config
from harness.spec import reference_module
from harness.weights import Layout, Redraw, draw

REF = reference_module("moe_decoder")
CONFIGS = [portbench_tiny.MIXTRAL, portbench_tiny.ARCTIC]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_redraw_is_bit_identical(cfg, monkeypatch):
    import harness.weights as w
    monkeypatch.setattr(w, "CHUNK", 4096)            # many chunks at a tiny size
    layout = Layout(cfg)
    params, _ = draw(layout, 3_000_000_017, "cpu")
    again = Redraw(layout, 3_000_000_017, "cpu", keep=2)
    assert torch.equal(again.leaf("embed"), params["embed"].float())
    assert torch.equal(again.leaf("layers/1/we2", 3), params["layers"][1]["we2"][3].float())
    assert torch.equal(again.leaf("layers/0/router"), params["layers"][0]["router"])
    assert not params["layers"][0]["ln1"].any()


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_reference_matches_the_port_plain_path(cfg):
    """Float32 logits at every position of two sequences: the reference
    against the port's full-sequence pass (``forward_train``, drop-free
    capacity) on the same weights."""
    from repro_torch.models.transformer import forward_train
    cfg = dict(cfg, torch_dtype="float32")
    layout = Layout(cfg)
    params, _ = draw(layout, 11, "cpu")
    pcfg = port_config(cfg)
    seqs = [list(range(5, 40)), [7, 3, 200, 1, 9, 9, 30]]
    ref = REF.logits(Redraw(layout, 11, "cpu"), cfg, seqs, "cpu")
    for s, r in zip(seqs, ref):
        with torch.no_grad():
            got, _ = forward_train(params, pcfg, torch.tensor([s]), remat="none",
                                   capacity_mode="full")
        assert r.shape == (len(s), cfg["vocab_size"])
        assert (got[0] - r).abs().max().item() < 1e-4


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_served_tokens_match_in_float32(cfg):
    """The whole run in float32 on the CPU: prefill, then decode through the
    ring cache in the ping-pong runtime; every served token is the
    reference's best to float32 rounding."""
    cell = portbench_tiny.cell(dict(cfg, torch_dtype="float32"), limit=1e-4)
    out = measure(cell, 5, 1.0, False, "cpu")
    assert out["correct"], out["readings"]
    assert out["readings"]["max_logit_gap"] < 1e-4
    assert len(out["gaps"]) >= 64


def test_fp8_control_rounds():
    t = torch.randn(64, 32)
    q = REF._fp8(t, -1)
    err = ((q - t).abs() / t.abs().amax(-1, keepdim=True)).max().item()
    assert 1e-3 < err < 0.07
