"""Named host spans on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler is recording, so the span lands in its host timeline beside the
device activity and shares its clock; otherwise it is one shared no-op
context (~1 us, against ~10 us for a ``record_function`` that records
nothing).  Nothing turns the spans on but a profiler that is running.

``SPANS`` lists every span the port opens and what it covers.
"""
from __future__ import annotations

import contextlib

import torch

SPANS = {
    "engine.step": "one Engine.step(): retire, admit, decode, sample",
    "engine.retire": "Engine._retire(): finished requests leave their rows",
    "engine.admit": "the step's admission, up to the host's read of the "
                    "first tokens, so its device work ends inside it",
    "engine.admit.plan": "Engine._admission_plan(): queues, slots, pages",
    "engine.admit.insert": "one request's KV written into its row or pages",
    "engine.decode.issue": "the decode step's inputs built and the decode "
                           "issued, up to the runtime's return",
    "engine.sample": "sampling the step's tokens, the host's wait for them, "
                     "and handing them to their requests",
    "engine.rebalance": "Engine._rebalance(): the live expert placement",
    "model.prefill": "models.transformer.prefill",
    "model.prefill.layer": "one layer of the prefill's layer stack",
    "model.prefill.attn": "a prefill layer's self-attention sublayer",
    "model.prefill.ffn": "a prefill layer's FFN (MoE) sublayer",
    "model.moe.combine": "the gate-weighted scatter-add of up to 16 "
                         "experts' outputs (moe.COMBINE_SPAN_EXPERTS; prefill, "
                         "monolithic and ping-pong decode)",
    "runtime.attn": "the attention stage of one micro-batch and layer",
    "runtime.expert": "the expert stage of one micro-batch and layer",
    "runtime.combine": "the combine of one micro-batch and layer",
    "runtime.m2n": "the M2N hop of one micro-batch and layer",
    "runtime.n2m": "the N2M hop of one micro-batch and layer",
}

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else the shared no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
