"""Byte-size formatting/parsing helpers used across benchmarks and reports."""
from __future__ import annotations

_UNITS = ["B", "KB", "MB", "GB", "TB", "PB"]


def human_bytes(n: float) -> str:
    """Format a byte count with a binary-ish (1000-based, like the paper) unit."""
    n = float(n)
    for unit in _UNITS:
        if abs(n) < 1000.0 or unit == _UNITS[-1]:
            if unit == "B":
                return f"{int(n)} {unit}"
            return f"{n:.2f} {unit}"
        n /= 1000.0
    raise AssertionError("unreachable")


def parse_bytes(s: str) -> int:
    """Parse '3 TB' / '512MB' / '1024' into a byte count."""
    s = s.strip()
    for i, unit in enumerate(_UNITS):
        if s.upper().endswith(unit) and (unit != "B" or not s.upper().endswith(("KB", "MB", "GB", "TB", "PB"))):
            num = s[: -len(unit)].strip()
            return int(float(num) * (1000 ** i))
    return int(float(s))
