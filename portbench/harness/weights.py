"""The model's weights, made by the benchmark from ``--seed`` on the card.

Every leaf of the tree the port's ``engine_for`` takes is a view into one
flat buffer per dtype.  The buffer is filled with standard normals in a
few large calls, one chunk of ``CHUNK`` elements at a time, each chunk
with a generator seeded from (seed, buffer, chunk index) alone; then
every leaf is scaled by its standard deviation in place (fan-in ** -0.5,
0.02 for the embedding) and the norm scales are zeroed (the port's
RMSNorm scales by 1 + scale).

Because a chunk depends on nothing but its index, ``leaf`` can draw any
one leaf again, bit for bit, without the rest: the reference draws its
weights itself after the program's state is freed, and so reads the
benchmark's inputs and nothing the program made or changed.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

CHUNK = 1 << 29          # elements per generator call
ALIGN = 128              # leaf offsets in elements (256 bytes of bf16)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Leaf:
    path: str
    shape: Tuple[int, ...]
    buffer: str              # "model" (the served dtype) or "f32"
    offset: int
    std: Optional[float]     # None: zeros

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def model_leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, Optional[float]]]:
    """(path, shape, buffer, std) of every leaf of a decoder of attention
    layers with a top-k MoE FFN (and an optional dense residual FFN), in
    the port's tree layout.  The router stays f32, as the port keeps it."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    E, f = cfg["num_local_experts"], cfg["intermediate_size"]
    fd = cfg.get("dense_residual_size", 0)
    fan = lambda n: n ** -0.5
    out = [("embed", (V, d), "model", 0.02),
           ("final_norm", (d,), "model", None),
           ("lm_head", (d, V), "model", fan(d))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers/{i}/"
        out += [(p + "ln1", (d,), "model", None), (p + "ln2", (d,), "model", None),
                (p + "wq", (d, H * hd), "model", fan(d)),
                (p + "wk", (d, Hkv * hd), "model", fan(d)),
                (p + "wv", (d, Hkv * hd), "model", fan(d)),
                (p + "wo", (H * hd, d), "model", fan(H * hd)),
                (p + "router", (d, E), "f32", fan(d)),
                (p + "we1", (E, d, f), "model", fan(d)),
                (p + "we3", (E, d, f), "model", fan(d)),
                (p + "we2", (E, f, d), "model", fan(f))]
        if fd:
            out += [(p + "wd1", (d, fd), "model", fan(d)),
                    (p + "wd3", (d, fd), "model", fan(d)),
                    (p + "wd2", (fd, d), "model", fan(fd))]
    return out


class Layout:
    """Offsets of every leaf in its buffer."""

    def __init__(self, cfg: dict):
        self.dtype = DTYPES[cfg["torch_dtype"]]
        self.leaves: Dict[str, Leaf] = {}
        self.sizes = {"model": 0, "f32": 0}
        for path, shape, buf, std in model_leaves(cfg):
            off = self.sizes[buf]
            self.leaves[path] = Leaf(path, tuple(shape), buf, off, std)
            n = math.prod(shape)
            self.sizes[buf] = off + -(-n // ALIGN) * ALIGN

    def buffer_dtype(self, buf: str) -> torch.dtype:
        return self.dtype if buf == "model" else torch.float32


def _chunk_seed(seed: int, buf: str, i: int) -> int:
    h = hashlib.blake2b(f"{seed}:{buf}:{i}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def _fill_chunk(out: torch.Tensor, seed: int, buf: str, i: int):
    gen = torch.Generator(device=out.device).manual_seed(_chunk_seed(seed, buf, i))
    out.normal_(generator=gen)


def draw(layout: Layout, seed: int, device) -> Tuple[dict, List[torch.Tensor]]:
    """(the port's parameter tree, the flat buffers it views)."""
    device = torch.device(device)
    flats = {}
    for buf, n in layout.sizes.items():
        flat = torch.empty(n, dtype=layout.buffer_dtype(buf), device=device)
        for i in range(0, -(-n // CHUNK)):
            _fill_chunk(flat[i * CHUNK:(i + 1) * CHUNK], seed, buf, i)
        flats[buf] = flat
    tree: dict = {"layers": []}
    for leaf in layout.leaves.values():
        t = flats[leaf.buffer][leaf.offset:leaf.offset + leaf.numel].view(leaf.shape)
        _finish(t, leaf)
        parts = leaf.path.split("/")
        if parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            tree["layers"][i][parts[2]] = t
        else:
            tree[parts[0]] = t
    return tree, list(flats.values())


def _finish(t: torch.Tensor, leaf: Leaf):
    if leaf.std is None:
        t.zero_()
    else:
        t.mul_(leaf.std)


class Redraw:
    """Draws single leaves (or one slice of a leaf's first axis) again,
    bit for bit as ``draw`` made them, keeping the last ``keep`` chunks it
    drew (an expert's three matrices lie in three chunks)."""

    def __init__(self, layout: Layout, seed: int, device, keep: int = 4):
        self.layout, self.seed, self.keep = layout, seed, keep
        self.device = torch.device(device)
        self._cached: Dict[Tuple[str, int], torch.Tensor] = {}

    def _chunk(self, buf: str, i: int) -> torch.Tensor:
        t = self._cached.pop((buf, i), None)
        if t is None:
            n = min(CHUNK, self.layout.sizes[buf] - i * CHUNK)
            t = torch.empty(n, dtype=self.layout.buffer_dtype(buf),
                            device=self.device)
            _fill_chunk(t, self.seed, buf, i)
            while len(self._cached) >= self.keep:
                self._cached.pop(next(iter(self._cached)))
        self._cached[(buf, i)] = t          # most recently used last
        return t

    def _range(self, buf: str, start: int, n: int) -> torch.Tensor:
        out = torch.empty(n, dtype=self.layout.buffer_dtype(buf), device=self.device)
        done = 0
        while done < n:
            i, o = divmod(start + done, CHUNK)
            take = min(n - done, CHUNK - o)
            out[done:done + take].copy_(self._chunk(buf, i)[o:o + take])
            done += take
        return out

    def leaf(self, path: str, index: Optional[int] = None) -> torch.Tensor:
        """The leaf (or its ``index``-th slice along the first axis) as
        made for the program, then as float32."""
        leaf = self.layout.leaves[path]
        shape, start = leaf.shape, leaf.offset
        if index is not None:
            shape = shape[1:]
            start += index * math.prod(shape)
        t = self._range(leaf.buffer, start, math.prod(shape)).view(shape)
        _finish(t, leaf)
        return t.float()

    def release(self):
        self._cached.clear()
