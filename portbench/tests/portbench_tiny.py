"""Tiny cells for the benchmark's CPU tests: the port's registered
architectures at a few widths, the chat traffic shape at 8 clients."""
from __future__ import annotations

import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
for p in (str(ROOT / "src"), str(PORTBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import Cell  # noqa: E402

MIXTRAL = {"name": "tiny-mixtral", "port_arch": "mixtral-8x22b",
           "reference": "moe_decoder", "torch_dtype": "bfloat16",
           "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
           "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 256,
           "rope_theta": 1000000.0, "rms_norm_eps": 1e-6}
ARCTIC = dict(MIXTRAL, name="tiny-arctic", port_arch="arctic-480b",
              hidden_size=56, intermediate_size=48, num_attention_heads=7,
              num_key_value_heads=1, head_dim=8, num_local_experts=16,
              dense_residual_size=48, rope_theta=10000.0)

TRAFFIC = {"loop": "closed", "clients": 8,
           "engine": {"runtime": "pingpong", "microbatches": 2,
                      "kv_layout": "contiguous", "max_batch": 8, "max_seq": 128},
           "prompt": {"dist": "exponential", "mean": 16, "min": 4, "max": 48},
           "output": {"dist": "exponential", "mean": 12, "min": 4, "max": 24},
           "start": {"output": {"dist": "residual", "of": "output"}},
           "block": 8, "warm_steps": 2}


def cell(config=MIXTRAL, limit: float = 0.5, **traffic) -> Cell:
    return Cell.of(config["name"], dict(config), dict(TRAFFIC, **traffic),
                   {"limits": {"mean_logit_gap": limit}, "sample_tokens": 64,
                    "per_group": 2})
