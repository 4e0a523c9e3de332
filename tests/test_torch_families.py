"""Every layer kind of the port against the JAX package, model by model,
on the CPU at reduced sizes (the recurrent and state-space families and
the local/global softcapped one; the cross-attention and MoE families
are in ``test_torch_families_cross.py``).

Per family (``_torch_family.FAMILIES``): the JAX params carried across by
``bridge.params_from_jax``; ``prefill`` logits and cache, then three
greedy ``decode_step``s, against JAX.  Tolerance: rtol = atol = 5e-4 on
logits and cache values (the JAX package's runtime-parity tolerance,
``tests/test_disagg_kernels.py``), greedy tokens and cache positions
identical.  The recurrences sum in another order than JAX's
associative scans (``test_torch_blocks.py``), which stays far inside it.
"""
import pytest
import torch

from _torch_family import FAMILIES, check_family
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

IDS = ["gemma2-27b", "recurrentgemma-2b", "recurrentgemma-2b+remainder",
       "mamba2-1.3b"]


@pytest.mark.parametrize("fid", IDS)
def test_family_prefill_and_decode_match_jax(fid):
    check_family(fid)


def test_every_family_is_held():
    from test_torch_families_cross import IDS as CROSS_IDS
    assert sorted(IDS + CROSS_IDS) == sorted(FAMILIES)


def test_recurrent_states_stay_f32_in_bf16():
    """In a bf16 model the ``h`` and ``ssm`` states are f32 and the conv
    caches bf16, at init and after prefill and decode."""
    from repro_torch.config import get_config, reduced
    for name in ("recurrentgemma-2b", "mamba2-1.3b"):
        cfg = reduced(get_config(name))
        p = ttf.init_params(cfg, 0, torch.bfloat16, device="cpu")
        _, cache = ttf.prefill(p, cfg, torch.tensor([[3, 4, 5]]), max_seq=8)
        ttf.decode_step(p, cfg, torch.tensor([6]), cache,
                        torch.tensor([3], dtype=torch.int32))
        for c in (cache, ttf.init_cache(cfg, 1, 8, torch.bfloat16, device="cpu")):
            for kind, e in zip(cfg.layer_kinds, c):
                for key, t in e.items():
                    want = (torch.float32 if key in ("h", "ssm")
                            else torch.int32 if key == "pos" else torch.bfloat16)
                    assert t.dtype == want, (name, kind, key, t.dtype)
