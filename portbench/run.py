"""Run one cell of the port's benchmark once.

    python portbench/run.py --workload lse1m.train --seed 7 --seconds 20 \\
        --trace 0

from the root of a checkout. The cell's configuration, traffic mix, limits
and per-layer readers are found by the names in ``BENCHMARK.json``
(``portbench/spec.py``). Prints, as the last line of its standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit, which also end its standard error.

Exits with another code, printing no result, where the checkout holds no
``sert_tpu_torch``, where the cell asks for more CUDA devices than there
are, where JAX or the JAX package got loaded, or where an end-to-end
metric got no reading.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sert_tpu")
PACKAGE = "sert_tpu_torch"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float) -> dict:
    """One run of ``workload`` on ``device``, without the look for a chip
    (the tests run it on the CPU); returns the result line's object. The
    cell's traffic names its runner, and its metrics their readers
    (``spec.py``); a metric whose reader finds nothing is left out."""
    import torch

    cell = spec.find_cell(root, workload)
    listed = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: spec.reader(root, m["name"]) for m in listed}
    runner = spec.runner(root, cell.traffic["kind"])
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        out = runner.run(cell, seed, seconds, trace, device, tmp, t_start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics = {}
    for m in listed:
        value = readers[m["name"]](out["view"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type),
            "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        info["busy_s"] = out.get("busy_s", 0.0)
        info["window_s"] = out.get("window_s", 0.0)
    if dev.type == "cuda":
        info["power"] = _power_limit()
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": info,
              **out.get("record", {})}
    if trace and "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def _plain(x):
    """``x`` with every number that JSON cannot hold written as text."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / PACKAGE / "__init__.py").is_file():
        print(f"portbench: no {PACKAGE} package in {ROOT}", file=sys.stderr)
        return 2
    try:
        cell = spec.find_cell(ROOT, args.workload)
    except (KeyError, OSError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    missing = [m["name"] for m in cell.end_to_end
               if m["name"] not in result["metrics"]]
    if not args.trace and missing:
        print(f"portbench: no reading of {', '.join(missing)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
