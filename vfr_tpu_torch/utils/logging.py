"""Structured JSONL metrics + console logging (the port of the JAX
package's ``utils/logging.py``): every record carries its tag, step and
wall-clock time."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # a crashed run can leave a torn (newline-less) last record:
            # start a fresh line rather than append onto it
            needs_nl = False
            if os.path.exists(path) and os.path.getsize(path) > 0:
                with open(path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    needs_nl = f.read(1) != b"\n"
            self._fh = open(path, "a", encoding="utf-8")
            if needs_nl:
                self._fh.write("\n")

    def log(self, tag: str, step: int, metrics: Dict[str, float]) -> None:
        rec = {
            "tag": tag,
            "step": int(step),
            "time": round(time.time(), 3),
            **{k: _jsonable(v) for k, v in metrics.items()},
        }
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            kv = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("tag", "time"))
            print(f"[{tag}] {kv}", file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def _jsonable(v):
    try:
        f = float(v)
        return int(f) if f.is_integer() and abs(f) < 1e15 else f
    except (TypeError, ValueError):
        return str(v)
