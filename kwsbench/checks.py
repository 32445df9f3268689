"""A number compared beside its limit."""

from __future__ import annotations

import math
from typing import Dict


def verdict(value, limit, exact: bool = False) -> Dict:
    """``value`` passes below ``limit`` (at most ``limit`` for an exact
    comparison, whose limit is 0); a number that is not finite, or below 0,
    fails."""
    v = float(value)
    finite = math.isfinite(v)
    ok = finite and v >= 0 and (v <= limit if exact else v < limit)
    return {"value": v if finite else str(v), "limit": limit, "ok": bool(ok)}
