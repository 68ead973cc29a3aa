"""CLI-style mini-parsers: temperature ladders, tau schedules, layer specs.

Reference: src/pmarlo/utils/input_parsing.py (parsers for bins/layers/
tau-schedules/temperature ladders).

Host copy of ``pmarlo_tpu/utils/input_parsing.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def parse_temperature_ladder(spec: "str | Sequence[float]") -> List[float]:
    """Parse a temperature ladder.

    Accepts an explicit list, a comma string ``"300,320,340"``, or a
    geometric range string ``"300:450:32"`` (min:max:n, geometric spacing —
    the canonical REMD ladder since exchange acceptance depends on
    beta-ratios).
    """
    if not isinstance(spec, str):
        ladder = [float(t) for t in spec]
    elif ":" in spec:
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(f"range ladder must be min:max:n, got {spec!r}")
        t_min, t_max, n = float(parts[0]), float(parts[1]), int(parts[2])
        if n < 2 or t_min <= 0 or t_max <= t_min:
            raise ValueError(f"invalid ladder spec {spec!r}")
        ladder = list(np.geomspace(t_min, t_max, n))
    else:
        ladder = [float(t) for t in spec.split(",") if t.strip()]
    if len(ladder) == 0:
        raise ValueError("empty temperature ladder")
    if any(t <= 0 for t in ladder):
        raise ValueError("temperatures must be positive")
    if sorted(ladder) != ladder:
        raise ValueError("temperature ladder must be non-decreasing")
    return ladder


def geometric_temperature_ladder(t_min: float, t_max: float, n: int) -> List[float]:
    return list(np.geomspace(float(t_min), float(t_max), int(n)))


def parse_tau_schedule(spec: "str | Sequence[int]") -> List[int]:
    """Parse a tau curriculum schedule: ``"2,5,10,20"`` or a list."""
    if isinstance(spec, str):
        values = [int(x) for x in spec.split(",") if x.strip()]
    else:
        values = [int(x) for x in spec]
    if not values or any(v < 1 for v in values):
        raise ValueError(f"invalid tau schedule {spec!r}")
    return values


def parse_hidden_layers(spec: "str | Sequence[int]") -> List[int]:
    """Parse hidden-layer widths: ``"64,64"`` or a list."""
    if isinstance(spec, str):
        values = [int(x) for x in spec.split(",") if x.strip()]
    else:
        values = [int(x) for x in spec]
    if any(v < 1 for v in values):
        raise ValueError(f"invalid hidden layers {spec!r}")
    return values


def parse_bins(spec: "str | int | Sequence[int]") -> List[int]:
    """Parse FES bin counts: int, "32", or "32,32"."""
    if isinstance(spec, int):
        return [spec, spec]
    if isinstance(spec, str):
        values = [int(x) for x in spec.split(",") if x.strip()]
    else:
        values = [int(x) for x in spec]
    if len(values) == 1:
        values = values * 2
    if len(values) != 2 or any(v < 2 for v in values):
        raise ValueError(f"invalid bins spec {spec!r}")
    return values


__all__ = [
    "parse_temperature_ladder",
    "geometric_temperature_ladder",
    "parse_tau_schedule",
    "parse_hidden_layers",
    "parse_bins",
]
