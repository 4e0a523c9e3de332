"""Needed work of each ``decode_attention`` launch, from the harness's own
record of each request's position.

The traced run marks every step; a step's launches come in the runtime's
launch order, one per (layer, micro-batch), micro-batch i over the rows
``run.mb_slices[i]``.  A launch over rows holding v_r valid KV positions
(the request's length after the step's write; an idle row needs none)
with H query heads and Hkv kv heads of width hd is charged for

  FLOPs  4 H hd sum(v_r)                     (q k and p v)
  bytes  2 Hkv hd sum(v_r) itemsize          (K and V of the valid slots)
         + 2 B H hd itemsize                 (q in, out)

Ring slots past a row's position, and idle rows' slots, count for
nothing.
"""
from __future__ import annotations

from typing import List, Tuple

KERNEL_NAMES = ("decode_attention_split_kernel", "decode_attention_merge_kernel")


def install(rec):
    import repro_torch.kernels.ops as ops

    def wrap(orig):
        def decode_attention(q, k_cache, v_cache, cache_pos, pos, **kwargs):
            if rec.on:
                B, H, hd = q.shape
                rec.log.append(("decode_attention", B, H, k_cache.shape[2], hd,
                                q.element_size()))
            return orig(q, k_cache, v_cache, cache_pos, pos, **kwargs)
        return decode_attention

    rec.patch(ops, "decode_attention", wrap)


def launch_need(valid: int, B: int, H: int, Hkv: int, hd: int,
                itemsize: int) -> Tuple[float, float]:
    return (4.0 * H * hd * valid,
            itemsize * (2.0 * Hkv * hd * valid + 2.0 * B * H * hd))


def need(log, run) -> List[Tuple[float, float]]:
    out, rows, i = [], None, 0
    m = len(run.mb_slices)
    for rec in log:
        if rec[0] == "step":
            rows, i = run.step_rows(rec[1]), 0
        elif rec[0] == "decode_attention":
            _, B, H, Hkv, hd, itemsize = rec
            s = run.mb_slices[i % m]
            i += 1
            if s.stop - s.start != B:
                raise ValueError(f"a decode_attention launch over {B} rows "
                                 f"where micro-batch {s} has {s.stop - s.start}")
            out.append(launch_need(int(rows[s].sum()), B, H, Hkv, hd, itemsize))
    return out
