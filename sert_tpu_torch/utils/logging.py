"""Logging utilities.

The reference used plain ``logging`` with per-batch loss prints (SURVEY.md
section 6, "Metrics / logging"). Here: a std logging setup plus a structured
JSONL step logger so train/score throughput (steps/sec, entities/sec/chip)
is machine-readable for the benchmark harness.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, IO, Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    """Return a configured logger; idempotent per-process root setup."""
    root = logging.getLogger("sert_tpu")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
    return logging.getLogger(f"sert_tpu.{name}")


class JsonlLogger:
    """Append-only JSONL event log (one JSON object per line).

    Used for step metrics: ``{"event": "train_step", "step": n, "loss": ...,
    "steps_per_sec": ...}``. A ``ts`` wall-clock field is added automatically.
    """

    def __init__(self, path: Optional[str] = None, stream: Optional[IO[str]] = None):
        self._path = path
        self._fh: Optional[IO[str]] = stream
        if path is not None and stream is None:
            self._fh = open(path, "a", buffering=1)

    def log(self, event: str, **fields: Any) -> None:
        if self._fh is None:
            return
        record = {"event": event, "ts": time.time()}
        record.update(fields)
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")

    def close(self) -> None:
        if self._fh is not None and self._path is not None:
            self._fh.close()
        self._fh = None

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
