"""Window extraction: the throughput-critical host-side sweep.

Reference behavior (SURVEY.md section 4.1): per document, per associated
entity, slide a width-n window over the encoded token stream and emit
(int32[n] term ids, int32 entity id) training instances.

Shape contract for the device: windows are ALWAYS exactly ``window_size``
wide. Documents shorter than the window emit one zero-padded window plus an
explicit ``length``; models compute a masked mean so padding never biases the
window representation (the reference's Theano graph took ragged input — a
TPU program cannot, so the mask is the TPU-native equivalent).

A C++ fast path for this sweep lives in sert_tpu_torch/native (same output
contract, tested for equality against this implementation).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


def window_count(num_tokens: int, window_size: int, stride: int = 1) -> int:
    if num_tokens <= 0:
        return 0
    if num_tokens < window_size:
        return 1
    return (num_tokens - window_size) // stride + 1


def extract_windows(
    token_ids: Sequence[int],
    entity_ids: Sequence[int],
    window_size: int,
    stride: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Windows for one document.

    Returns (windows int32[N, window_size], lengths int32[N], entities
    int32[N]) where N = window_count * len(entity_ids): every window is
    emitted once per associated entity, as in the reference.
    """
    ids = np.asarray(token_ids, dtype=np.int32)
    ents = np.asarray(entity_ids, dtype=np.int32)
    n_tok = ids.shape[0]
    n_win = window_count(n_tok, window_size, stride)
    if n_win == 0 or ents.shape[0] == 0:
        return (np.zeros((0, window_size), np.int32),
                np.zeros((0,), np.int32),
                np.zeros((0,), np.int32))

    if n_tok < window_size:
        windows = np.zeros((1, window_size), np.int32)
        windows[0, :n_tok] = ids
        lengths = np.array([n_tok], np.int32)
    else:
        # Strided view -> copy: one vectorized sweep, no Python-level loop.
        windows = np.lib.stride_tricks.sliding_window_view(ids, window_size)[::stride]
        windows = np.ascontiguousarray(windows, dtype=np.int32)
        lengths = np.full((windows.shape[0],), window_size, np.int32)

    n_ent = ents.shape[0]
    rep_windows = np.repeat(windows, n_ent, axis=0)
    rep_lengths = np.repeat(lengths, n_ent)
    rep_entities = np.tile(ents, windows.shape[0])
    return rep_windows, rep_lengths, rep_entities


def iter_document_windows(
    docs: Iterator[Tuple[str, List[int]]],
    assoc,
    window_size: int,
    stride: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Sweep a (doc_id, token_ids) stream; yields per-doc window arrays for
    documents that have at least one associated entity."""
    for doc_id, token_ids in docs:
        ents = assoc.entities_for(doc_id)
        if not ents:
            continue
        w, l, e = extract_windows(token_ids, ents, window_size, stride)
        if w.shape[0]:
            yield w, l, e
