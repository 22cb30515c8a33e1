"""ctypes loader for the C++ window-sweep library (graceful fallback).

``maybe_load()`` returns a module-like object with ``extract_windows`` once
``g++`` has built ``text.cc`` and ``window_sweep.cc`` (at first use, into
the git-ignored ``build/`` beside the package, named by a hash of the
sources and flags), else None — callers fall back to the numpy
implementation with identical output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import Optional, Sequence, Tuple

import numpy as np

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build")
# Portable codegen: the library may land in a directory shared across
# hosts, where one host's -march=native binary can SIGILL on another. The
# sweep is string/memory-bound, so the difference is marginal.
_GXX_FLAGS = ("-O3", "-mtune=generic", "-shared", "-fPIC")
_cached: Optional["_NativeWindows"] = None
_load_attempted = False


class NativeVocab:
    """Handle wrapper for the C++ term->id encoder. Tokenization filters
    that shaped the vocabulary (stopwords etc.) are irrelevant at encode
    time beyond lowercasing — filtered terms are simply absent — but the
    same options are applied for exact parity with the Python path."""

    def __init__(self, lib: ctypes.CDLL, terms, lowercase=True,
                 filter_stopwords=True, min_token_len=1, drop_numeric=False):
        self._lib = lib
        self._lowercase = lowercase
        blob = b"\0".join(t.encode() for t in terms) + b"\0"
        self._n = len(terms)
        self._handle = lib.sert_vocab_create(
            blob, self._n, int(lowercase), int(filter_stopwords),
            int(min_token_len), int(drop_numeric))

    def encode(self, text: str) -> np.ndarray:
        # Lowercase in PYTHON first: str.lower() maps some non-ASCII chars
        # to ASCII (U+212A Kelvin -> 'k', U+0130 -> 'i'+combining), which the
        # byte-wise C++ scanner cannot reproduce; the native lowercase flag
        # then only re-lowers ASCII (a no-op here), keeping byte-identical
        # parity with the pure-Python tokenizer.
        if self._lowercase:
            text = text.lower()
        data = text.encode()
        cap = max(len(data), 1)
        out = np.empty(cap, np.int32)
        n = self._lib.sert_vocab_encode(
            self._handle, data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        return out[:n]

    def __del__(self):
        try:
            self._lib.sert_vocab_free(self._handle)
        except Exception:
            pass


class NativeCounter:
    """Handle wrapper for the C++ token counter (vocabulary pass 1)."""

    def __init__(self, lib: ctypes.CDLL, lowercase=True,
                 filter_stopwords=True, min_token_len=1, drop_numeric=False):
        self._lib = lib
        self._lowercase = lowercase
        self._handle = lib.sert_counter_create(
            int(lowercase), int(filter_stopwords), int(min_token_len),
            int(drop_numeric))

    def add(self, text: str) -> None:
        if self._lowercase:
            text = text.lower()  # Unicode-aware; see NativeVocab.encode
        data = text.encode()
        self._lib.sert_counter_add(self._handle, data, len(data))

    def counts(self) -> dict:
        size = self._lib.sert_counter_serialize(self._handle)
        buf = ctypes.create_string_buffer(size)
        self._lib.sert_counter_copy(self._handle, buf)
        out = {}
        for line in bytes(buf).decode().splitlines():
            term, _, count = line.rpartition("\t")
            out[term] = int(count)
        return out

    def __del__(self):
        try:
            self._lib.sert_counter_free(self._handle)
        except Exception:
            pass


class _NativeWindows:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._lib.sert_window_count.restype = ctypes.c_int64
        self._lib.sert_window_count.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        self._lib.sert_extract_windows.restype = None
        self._lib.sert_extract_windows.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,   # token ids
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,   # entity ids
            ctypes.c_int64, ctypes.c_int64,                   # window, stride
            ctypes.POINTER(ctypes.c_int32),                   # out windows
            ctypes.POINTER(ctypes.c_int32),                   # out lengths
            ctypes.POINTER(ctypes.c_int32),                   # out entities
        ]
        self._lib.sert_batch_instance_count.restype = ctypes.c_int64
        self._lib.sert_batch_instance_count.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        self._lib.sert_extract_windows_batch.restype = None
        self._lib.sert_extract_windows_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        # text pipeline (may be absent in a stale .so; probed by hasattr)
        self.has_text = hasattr(lib, "sert_vocab_create")
        if self.has_text:
            lib.sert_counter_create.restype = ctypes.c_void_p
            lib.sert_counter_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int]
            lib.sert_counter_add.restype = None
            lib.sert_counter_add.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            lib.sert_counter_serialize.restype = ctypes.c_int64
            lib.sert_counter_serialize.argtypes = [ctypes.c_void_p]
            lib.sert_counter_copy.restype = None
            lib.sert_counter_copy.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.sert_counter_free.restype = None
            lib.sert_counter_free.argtypes = [ctypes.c_void_p]
            lib.sert_vocab_create.restype = ctypes.c_void_p
            lib.sert_vocab_create.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int]
            lib.sert_vocab_encode.restype = ctypes.c_int64
            lib.sert_vocab_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
            lib.sert_vocab_free.restype = None
            lib.sert_vocab_free.argtypes = [ctypes.c_void_p]

    def make_counter(self, **kw) -> "NativeCounter":
        return NativeCounter(self._lib, **kw)

    def make_vocab(self, terms, **kw) -> "NativeVocab":
        return NativeVocab(self._lib, terms, **kw)

    def extract_windows(
        self,
        token_ids: Sequence[int],
        entity_ids: Sequence[int],
        window_size: int,
        stride: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ids = np.ascontiguousarray(token_ids, dtype=np.int32)
        ents = np.ascontiguousarray(entity_ids, dtype=np.int32)
        n_tok, n_ent = ids.shape[0], ents.shape[0]
        n_win = int(self._lib.sert_window_count(n_tok, window_size, stride))
        n_out = n_win * n_ent
        windows = np.zeros((n_out, window_size), np.int32)
        lengths = np.empty((n_out,), np.int32)
        entities = np.empty((n_out,), np.int32)
        if n_out:
            i32p = ctypes.POINTER(ctypes.c_int32)
            self._lib.sert_extract_windows(
                ids.ctypes.data_as(i32p), n_tok,
                ents.ctypes.data_as(i32p), n_ent,
                window_size, stride,
                windows.ctypes.data_as(i32p),
                lengths.ctypes.data_as(i32p),
                entities.ctypes.data_as(i32p),
            )
        return windows, lengths, entities


    def extract_windows_batch(
        self,
        tokens: np.ndarray, doc_offsets: np.ndarray,
        entities: np.ndarray, ent_offsets: np.ndarray,
        window_size: int, stride: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sweep many concatenated documents in one native call.

        tokens int32[sum_tok], doc_offsets int64[n_docs+1], entities
        int32[sum_ent], ent_offsets int64[n_docs+1].
        """
        tokens = np.ascontiguousarray(tokens, np.int32)
        doc_offsets = np.ascontiguousarray(doc_offsets, np.int64)
        entities = np.ascontiguousarray(entities, np.int32)
        ent_offsets = np.ascontiguousarray(ent_offsets, np.int64)
        n_docs = doc_offsets.shape[0] - 1
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        total = int(self._lib.sert_batch_instance_count(
            doc_offsets.ctypes.data_as(i64p), ent_offsets.ctypes.data_as(i64p),
            n_docs, window_size, stride))
        windows = np.zeros((total, window_size), np.int32)
        lengths = np.empty((total,), np.int32)
        ents = np.empty((total,), np.int32)
        if total:
            self._lib.sert_extract_windows_batch(
                tokens.ctypes.data_as(i32p), doc_offsets.ctypes.data_as(i64p),
                entities.ctypes.data_as(i32p), ent_offsets.ctypes.data_as(i64p),
                n_docs, window_size, stride,
                windows.ctypes.data_as(i32p), lengths.ctypes.data_as(i32p),
                ents.ctypes.data_as(i32p))
        return windows, lengths, ents


def _sources():
    d = os.path.dirname(os.path.abspath(__file__))
    return [os.path.join(d, f) for f in ("window_sweep.cc", "text.cc")]


def lib_path() -> str:
    """The library's path in BUILD_DIR, named by a hash of the sources and
    the compiler flags: changed sources build a new library, never load a
    stale one."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libsert_native-{h.hexdigest()[:16]}.so")


def _try_build(path: str) -> bool:
    """Compile the native library, concurrency-safe: to a tmp name, then
    os.replace, so two processes racing both end with a whole library. Any
    failure (no g++, read-only build dir, sandbox) returns False and the
    numpy path takes over. SERT_NO_NATIVE_BUILD=1 disables the attempt."""
    if os.environ.get("SERT_NO_NATIVE_BUILD"):
        return False
    import shutil
    import subprocess
    import tempfile
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return False
    tmp = None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
        os.close(fd)
        subprocess.run([gxx, *_GXX_FLAGS, "-o", tmp] + _sources(),
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        tmp = None
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def maybe_load() -> Optional[_NativeWindows]:
    global _cached, _load_attempted
    if _load_attempted:
        return _cached
    _load_attempted = True
    path = lib_path()
    if not os.path.exists(path) and not _try_build(path):
        return None
    try:
        _cached = _NativeWindows(ctypes.CDLL(path))
    except (OSError, AttributeError):
        # OSError: unloadable .so. AttributeError: a loadable library
        # missing expected symbols — the numpy path takes over.
        _cached = None
    return _cached
