"""Structured metric logging (counterpart of `psvo_tpu/utils/metrics.py`).

An append-only JSONL file per run, line-buffered so a reader can tail it;
each record carries its step and, unless it has one, the wall-clock time.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsWriter:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)

    def write(self, record: dict) -> None:
        rec = dict(record)
        rec.setdefault("time", time.time())
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
