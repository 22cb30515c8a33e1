"""Wire-format packing for the host->device training feed (port of
``sert_tpu/data/wirepack.py``; the host side is its copy, the unpack is
torch).

The training batch is three int32 planes — windows [.., B, w], lengths
[.., B], entities [.., B] — 4 bytes per id regardless of how many bits
the id actually needs. Packing (host side, numpy, on the feeder thread):

- every id plane splits into a uint16 LOW half and, only when the id
  space needs >16 bits, a HIGH plane of ``hb`` bits per id with ``hb``
  rounded up to {1, 2, 4, 8} so a whole number of ids pack per byte.
  Window HIGH bits pack along the window axis; the entity HIGH plane
  stays one byte per row, so the batch axis stays intact.
- lengths (<= window size <= 255) travel as uint8.

At vocab 250k / 1M entities / w=8 this is 18 + 3 + 1 = 22 bytes per
instance vs 40 raw. Ids must fit 24 bits (16.7M) — wider spaces fall
back to raw transfer.

:func:`unpack_batch` runs on the device the planes sit on (a widening
to int32, shifts and ors); the roundtrip is bit-exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_MAX_BITS = 24          # hi plane must fit uint8
_MAX_WINDOW = 255       # lengths travel as uint8


def hi_bits(n: int) -> int:
    """Bits needed above the low uint16 for ids in [0, n), rounded up to
    a byte-aligned group size (0, 1, 2, 4 or 8). Raises if ids cannot be
    packed at all."""
    if n <= 0:
        raise ValueError(f"id space must be positive, got {n}")
    bits = max(int(n - 1).bit_length(), 1)
    if bits > _MAX_BITS:
        raise ValueError(
            f"id space {n} needs {bits} bits; wire packing supports up "
            f"to {_MAX_BITS} (uint8 hi plane) — use raw transfer")
    extra = max(bits - 16, 0)
    for g in (0, 1, 2, 4, 8):
        if extra <= g:
            return g
    raise AssertionError  # unreachable: extra <= 8 by the check above


def packable(vocab_size: int, num_entities: int) -> bool:
    """True when both id spaces fit the packed wire format."""
    try:
        hi_bits(vocab_size)
        hi_bits(num_entities)
        return True
    except ValueError:
        return False


def _pack_hi_axis(hi: np.ndarray, hb: int) -> np.ndarray:
    """Pack the trailing axis of ``hi`` (< 2**hb values) ``8 // hb`` ids
    per byte. Trailing axis is padded with zeros to a whole byte."""
    g = 8 // hb
    w = hi.shape[-1]
    wp = -(-w // g) * g
    if wp != w:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, wp - w)]
        hi = np.pad(hi, pad)
    grouped = hi.reshape(hi.shape[:-1] + (wp // g, g)).astype(np.uint32)
    shifts = (np.arange(g, dtype=np.uint32) * hb)
    return (grouped << shifts).sum(axis=-1).astype(np.uint8)


def pack_batch(batch: Dict[str, np.ndarray], vocab_size: int,
               num_entities: int) -> Dict[str, np.ndarray]:
    """Host-side: int32 batch -> packed wire batch (numpy, cheap)."""
    windows = np.asarray(batch["windows"])
    entities = np.asarray(batch["entities"])
    lengths = np.asarray(batch["lengths"])
    if windows.shape[-1] > _MAX_WINDOW:
        # feed_enabled gates on window size, so reaching here means a
        # caller bypassed it; failing is mandatory — uint8 lengths would
        # WRAP (300 -> 44) and silently corrupt the pooling masks.
        raise ValueError(
            f"wire packing supports windows up to {_MAX_WINDOW} tokens "
            f"(uint8 lengths); got {windows.shape[-1]}")
    out = {
        "wlo": (windows & 0xFFFF).astype(np.uint16),
        "elo": (entities & 0xFFFF).astype(np.uint16),
        "len": lengths.astype(np.uint8),
    }
    hb_w = hi_bits(vocab_size)
    if hb_w:
        out["whi"] = _pack_hi_axis((windows >> 16).astype(np.uint8), hb_w)
    hb_e = hi_bits(num_entities)
    if hb_e:
        # one byte per row: the batch axis stays intact
        out["ehi"] = (entities >> 16).astype(np.uint8)
    return out


def unpack_batch(packed: Dict[str, torch.Tensor], vocab_size: int,
                 num_entities: int) -> Dict[str, torch.Tensor]:
    """Packed wire batch (tensors on any device) -> the standard int32
    batch dict on that device, for any leading axes ([B, ..] or the
    stacked [n, B, ..] of steps_per_call). The window width comes from
    the packed arrays themselves (wlo's last axis), so the unpacker
    cannot disagree with whatever width the dataset was prepared with."""
    wlo = packed["wlo"]
    window = wlo.shape[-1]
    windows = wlo.to(torch.int32)
    hb_w = hi_bits(vocab_size)
    if hb_w:
        g = 8 // hb_w
        whi = packed["whi"].to(torch.int32)            # [.., ceil(w/g)]
        shifts = torch.arange(g, dtype=torch.int32, device=whi.device) * hb_w
        hi = (whi[..., None] >> shifts) & ((1 << hb_w) - 1)  # [.., wp/g, g]
        hi = hi.reshape(tuple(whi.shape[:-1]) + (-1,))[..., :window]
        windows = windows | (hi << 16)
    entities = packed["elo"].to(torch.int32)
    if hi_bits(num_entities):
        entities = entities | (packed["ehi"].to(torch.int32) << 16)
    return {
        "windows": windows,
        "lengths": packed["len"].to(torch.int32),
        "entities": entities,
    }


def packed_nbytes(batch: Dict[str, np.ndarray]) -> int:
    return sum(np.asarray(v).nbytes for v in batch.values())


def feed_enabled(mode: str, vocab_size: int, num_entities: int,
                 window_size: int = 1) -> bool:
    """Resolve TrainConfig.packed_feed. "on" validates loudly: both id
    spaces and the window width must fit the wire format. "auto" keeps
    the reference's rule, on only on the TPU backend (the packing exists
    for its feed-bandwidth-bound link), so it is off here."""
    if mode == "off":
        return False
    fits = (packable(vocab_size, num_entities)
            and window_size <= _MAX_WINDOW)
    if mode == "on":
        if not fits:
            raise ValueError(
                f"packed_feed='on' but the geometry exceeds the wire "
                f"format (vocab={vocab_size}, entities={num_entities} "
                f"must fit {_MAX_BITS} bits; window_size={window_size} "
                f"must be <= {_MAX_WINDOW}); use 'off'")
        return True
    if mode != "auto":
        raise ValueError(f"unknown packed_feed mode: {mode!r}")
    return False
