"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under the benchmark's folder:

    configs/<config>.json     named by the config's ``file`` entry
    traffic/<traffic>.json    the mix's parameters; its ``kind`` names
    <kind>_cell.py            the module that runs cells of such traffic
    limits/<workload>.json    each compared number's limit in that cell
    metrics/<metric>.py       a reader: ``read(view) -> float or None``,
                              for end-to-end and per-layer metrics alike

A quantity split over cells that report different end-to-end metrics
(``k1_roofline`` and ``k1_roofline.lazy``) is read by one reader, the
file of the name before its first dot, unless the whole name has a file
of its own. So a later change adds a cell, a configuration, a mix, a
kind of traffic or a metric by adding files and entries, and edits none.

A runner's ``run(cell, seed, seconds, trace, device, tmp, t_start)``
returns the run's outcome: ``correct``, ``attempted``, ``failed``,
``checks``, ``memory_peak_bytes``, with a device trace ``busy_s``,
``window_s`` and ``breakdown``, optionally a ``record`` printed with the
result, and the ``view`` that the cell's readers read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]      # the cell's end-to-end metrics
    per_layer: List[Dict]       # the cell's per-layer metrics


def _load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _one(entries: List[Dict], name: str, what: str) -> Dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named "
                       f"{name!r}")
    return found[0]


def find_cell(root: Path, name: str) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    work = _one(bench["workloads"], name, "workloads")
    conf = _one(bench["configs"], work["config"], "configs")
    here = root / BENCH_DIR
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name=name, chips=int(work["chips"]),
                config=_load_json(root / conf["file"]),
                traffic=_load_json(here / "traffic"
                                   / f"{work['traffic']}.json"),
                limits=_load_json(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def _load(path: Path, name: str):
    """The module of ``path``, loaded once under ``name`` (a module held
    in ``sys.modules`` while it runs, as dataclasses need)."""
    loaded = sys.modules.get(name)
    if loaded is not None and getattr(loaded, "__file__", None) == str(path):
        return loaded
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def _module_name(kind: str, name: str) -> str:
    return f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"


def runner(root: Path, kind: str):
    """The module ``<kind>_cell.py`` that runs cells of that traffic."""
    return _load(Path(root) / BENCH_DIR / f"{kind}_cell.py",
                 _module_name("runner", kind))


def reader(root: Path, metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``, or of the file of
    the name before its first dot."""
    here = Path(root) / BENCH_DIR / "metrics"
    path = here / f"{metric}.py"
    if not path.is_file():
        path = here / f"{metric.split('.')[0]}.py"
    return _load(path, _module_name("metric", metric)).read
