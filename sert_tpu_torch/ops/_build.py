"""Build and bind the port's CUDA kernels (``sert_tpu_torch/csrc/*.cu``).

The kernels have a plain C interface and are loaded with ``ctypes``: at
first use one nvcc per ``csrc/*.cu`` compiles it for ``sm_90a`` (all of
them at once, in parallel), with no PyTorch headers involved, and a last
nvcc links the objects into one shared library. The library
lands in ``build/`` beside the package (git-ignored), named by a hash of
the sources and flags, so an unchanged tree reuses it and a changed one
rebuilds. Pointers and the stream go over as ``c_void_p``; every entry
point returns the launch's ``cudaGetLastError()``, which :func:`check`
turns into an exception.

Nothing here runs at import time: the CPU tests import every module on a
host with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# Every exported entry point and its C signature (all return cudaError_t).
_SIGNATURES = {
    "sert_score_binmax": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sert_score_binmax_f32": [_P] * 5 + [_I] * 8 + [_P],
    "sert_gather_rescore_f32": [_P] * 5 + [_I] * 9 + [_P],
    "sert_gather_rescore_bf16": [_P] * 5 + [_I] * 9 + [_P],
    "sert_sampled_lse_fwd": [_P] * 7 + [_I] * 7 + [_P],
    "sert_sampled_lse_bwd": [_P] * 10 + [_I] * 9 + [_P],
    "sert_xent_fwd": [_P] * 5 + [_I] * 4 + [_L] * 2 + [_I] * 3 + [_P],
    "sert_xent_bwd": [_P] * 10 + [_I] * 4 + [_L] * 2 + [_I] * 6 + [_P],
    "sert_xent_wgmma_fwd": [_P] * 5 + [_I] * 4 + [_L] + [_I] * 4 + [_P],
    "sert_xent_wgmma_bwd": [_P] * 10 + [_I] * 4 + [_L] + [_I] * 6 + [_P],
    "sert_xent_wgmma_dpooled": [_P] * 6 + [_I] * 4 + [_L] + [_I] * 4 + [_P],
    "sert_xent_bwd_apply": ([_P] * 11 + [_I] * 4 + [_L] * 2 + [_I] * 6
                            + [_F] * 4 + [_I] + [_P]),
    "sert_xent_wgmma_apply": ([_P] * 11 + [_I] * 4 + [_L] + [_I] * 5
                              + [_F] * 4 + [_I] + [_P]),
    "sert_adam_update_f32": [_P, _I] + [_F] * 9 + [_I, _P] + [_F] * 2 + [_P],
    "sert_adam_update_bf16": [_P, _I] + [_F] * 9 + [_I, _P] + [_F] * 2 + [_P],
    "sert_adam_update_bf16_f32grad": ([_P, _I] + [_F] * 9 + [_I, _P]
                                      + [_F] * 2 + [_P]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Seconds the last nvcc run took (None when the cached library was reused).
last_build_seconds: Optional[float] = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are compiled from sert_tpu_torch/csrc at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsert_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists:
    one nvcc per source, all started together, then one link. Writes the
    compilers' output (with ptxas' register and spill report) beside the
    library as ``.log``."""
    global last_build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = path.with_name(f"{path.stem}.{os.getpid()}")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = Path(f"{stem}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    if not failed:
        tmp = Path(f"{stem}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    path.with_suffix(".log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{text}")
    os.replace(tmp, path)       # atomic: a concurrent builder sees all or none
    last_build_seconds = time.perf_counter() - t0
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sert_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sert_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def kernel(name: str):
    return getattr(load(), name)


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = load().sert_cuda_error_string(code).decode()
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {code} ({msg})")
