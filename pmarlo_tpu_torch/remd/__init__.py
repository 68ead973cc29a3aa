"""Replica-exchange MD.

The names of the JAX package's ``remd/__init__.py`` resolve lazily through
the module ``__getattr__``.
"""

from __future__ import annotations

import importlib
from typing import Any

# name -> module of this package that defines it
_EXPORTS = {
    "RemdConfig": "remd",
    "RemdResult": "remd",
    "ReplicaExchange": "remd",
    "run_replica_exchange": "remd",
    "suggest_temperature_ladder": "ladder",
}


def __getattr__(name: str) -> Any:
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = ["RemdConfig", "RemdResult", "ReplicaExchange",
           "run_replica_exchange", "suggest_temperature_ladder"]
