"""Helpers shared by the mobile families (eqxvision_tpu/utils.py)."""
from __future__ import annotations

from typing import Optional


def _make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """TF-slim channel rounding of the mobile nets: ``v`` to the nearest
    multiple of ``divisor``, at least ``min_value`` (``divisor`` if omitted)
    and never below 90% of ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v
