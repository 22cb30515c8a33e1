"""The LSE model's initial weights, made on the device from the seed.

Each leaf is drawn N(0, 1/dim) in float32 and stored in the parameter
dtype, as the LSE model initializes it (``proj_b`` is zero). A leaf is
drawn in blocks of ``BLOCK_ROWS`` rows, each from a generator of its own
seeded by (seed, leaf, block), so that any block can be made again alone:
the check regenerates the start blocks it needs after the program has
changed its copy, and never holds a second copy of a table.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

BLOCK_ROWS = 1 << 20
LEAVES = ("word_emb", "proj_w", "proj_b", "entity_emb")
ROW_LEAVES = ("word_emb", "entity_emb")     # tables a step touches by rows


def shapes(dims: Dict[str, int]) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """leaf -> (shape, the dim its init scales by; 0: zeros)."""
    V, E = dims["vocab_size"], dims["num_entities"]
    dw, de = dims["word_dim"], dims["entity_dim"]
    return {"word_emb": ((V, dw), dw), "proj_w": ((dw, de), dw),
            "proj_b": ((de,), 0), "entity_emb": ((E, de), de)}


def block_seed(seed: int, leaf: str, block: int) -> int:
    words = np.random.SeedSequence(
        [int(seed), LEAVES.index(leaf), block]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def blocks(dims: Dict[str, int], leaf: str) -> Iterator[Tuple[int, int]]:
    rows = shapes(dims)[leaf][0][0]
    for lo in range(0, rows, BLOCK_ROWS):
        yield lo, min(lo + BLOCK_ROWS, rows)


def make_block(seed: int, dims: Dict[str, int], leaf: str, lo: int, hi: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """Rows [lo, hi) of ``leaf`` (``lo`` a block start)."""
    shape, dim = shapes(dims)[leaf]
    if dim == 0:
        return torch.zeros((hi - lo, *shape[1:]), dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(
        block_seed(seed, leaf, lo // BLOCK_ROWS))
    x = torch.randn((hi - lo, *shape[1:]), generator=g, dtype=torch.float32,
                    device=device)
    return (x * (1.0 / math.sqrt(dim))).to(dtype)


@torch.no_grad()
def fill(params: Dict[str, torch.Tensor], seed: int,
         dims: Dict[str, int]) -> None:
    """Overwrite every leaf of ``params`` in place with the seed's values."""
    for leaf in LEAVES:
        p = params[leaf]
        if tuple(p.shape) != shapes(dims)[leaf][0]:
            raise ValueError(f"{leaf}: shape {tuple(p.shape)}, configuration "
                             f"{shapes(dims)[leaf][0]}")
        for lo, hi in blocks(dims, leaf):
            p[lo:hi] = make_block(seed, dims, leaf, lo, hi, p.dtype, p.device)


@torch.no_grad()
def rows(seed: int, dims: Dict[str, int], leaf: str,
         ids: Optional[torch.Tensor], dtype: torch.dtype,
         device) -> torch.Tensor:
    """The start values of ``leaf``'s rows ``ids`` (sorted int64 on
    ``device``), in ``dtype``; the whole leaf where ``ids`` is None."""
    if ids is None:
        return make_block(seed, dims, leaf, 0, shapes(dims)[leaf][0][0],
                          dtype, device)
    out = []
    for lo, hi in blocks(dims, leaf):
        sel = ids[(ids >= lo) & (ids < hi)]
        if sel.numel():
            out.append(make_block(seed, dims, leaf, lo, hi, dtype,
                                  device)[sel - lo])
    return torch.cat(out)
