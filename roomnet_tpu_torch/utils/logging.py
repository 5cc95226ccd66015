"""Structured logging (port of roomnet_tpu/utils/logging.py).

One logger factory gives every subsystem a namespaced logger under the
``roomnet_tpu_torch`` root with one format, plus an optional JSON-lines
event stream for machine consumption.
"""

from __future__ import annotations

import json
import logging
import sys
import time

_FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("roomnet_tpu_torch")
        if not root.handlers:
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(f"roomnet_tpu_torch.{name}")


class EventLog:
    """Append-only JSON-lines event stream (step metrics, requests, ...)."""

    def __init__(self, path: str | None):
        self.path = path

    def emit(self, kind: str, **fields):
        if self.path is None:
            return
        rec = {"ts": time.time(), "kind": kind, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
