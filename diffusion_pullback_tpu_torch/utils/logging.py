"""Structured logging: JSONL + console (counterpart of
diffusion_pullback_tpu/utils/logging.py). Under a torch.distributed run
only rank 0 writes and prints."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class JSONLLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        from ..parallel.mesh import is_writer

        writer = is_writer()
        self.path = path
        self.echo = echo and writer
        self._fh = None
        if path and writer:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, event: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"ts": round(time.time(), 3), "event": event}
        rec.update(fields)
        line = json.dumps(rec, default=_jsonable)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(f"[{event}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
                  file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()


def _jsonable(o):
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)
