"""Thin logging shim: consistent formatting, env-controlled verbosity.

Configuration is idempotent *per level*: every ``get_logger`` call re-reads
``REPRO_LOG`` and reapplies the level if the env var changed, but the stream
handler is attached exactly once (guarded by a marker attribute, so parallel
first-calls can never double-configure the ``repro_torch`` root logger).

Structured extras: pass ``extra=kv(key=value, ...)`` to any log call and the
formatter appends sorted ``key=value`` pairs — the tracer reuses this to log
span boundaries without bespoke string formatting.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Any, Dict

_HANDLER_MARK = "_repro_kv_handler"


class KvFormatter(logging.Formatter):
    """Standard formatter plus sorted ``k=v`` pairs from ``record.kv``."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        pairs = getattr(record, "kv", None)
        if pairs:
            tail = " ".join(f"{k}={pairs[k]}" for k in sorted(pairs))
            return f"{base} {tail}"
        return base


def kv(**pairs: Any) -> Dict[str, Any]:
    """Build the ``extra=`` dict for a structured log call."""
    return {"kv": pairs}


def _ensure_configured() -> logging.Logger:
    root = logging.getLogger("repro_torch")
    if not any(getattr(h, _HANDLER_MARK, False) for h in root.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(KvFormatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
        setattr(handler, _HANDLER_MARK, True)
        root.addHandler(handler)
        root.propagate = False
    # Re-read the env var every call: level changes are applied idempotently
    # instead of latching whatever the first caller saw.
    level = getattr(logging, os.environ.get("REPRO_LOG", "INFO").upper(), logging.INFO)
    if root.level != level:
        root.setLevel(level)
    return root


def get_logger(name: str) -> logging.Logger:
    _ensure_configured()
    return logging.getLogger(f"repro_torch.{name}" if not name.startswith("repro_torch") else name)
