"""Host-side numpy utilities (seeding, thermodynamics, MSM and IO helpers).

The names of the JAX package's ``utils/__init__.py`` resolve lazily through
the module ``__getattr__``.
"""

from __future__ import annotations

import importlib
from typing import Any

# name -> module of this package that defines it
_EXPORTS = {
    "set_global_seed": "seed",
    "choose_sim_seed": "seed",
    "extract_seed": "seed",
    "kT_kJ_per_mol": "thermodynamics",
    "beta_per_kJ_mol": "thermodynamics",
    "PmarloError": "errors",
    "TemperatureConsistencyError": "errors",
    "WhiteningError": "errors",
}


def __getattr__(name: str) -> Any:
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = [
    "set_global_seed",
    "choose_sim_seed",
    "extract_seed",
    "kT_kJ_per_mol",
    "beta_per_kJ_mol",
    "PmarloError",
    "TemperatureConsistencyError",
    "WhiteningError",
]
