"""Molecular dynamics: system, force field, forces, integrator, fused kernel.

The names of the JAX package's ``md/__init__.py`` resolve lazily through
the module ``__getattr__`` (importing the package builds no kernel and
imports none of its modules).
"""

from __future__ import annotations

import importlib
from typing import Any

# name -> module of this package that defines it, as the JAX package's
# ``md/__init__.py`` imports them
_EXPORTS = {
    "System": "system",
    "build_system": "forcefield",
    "potential_energy": "forces",
    "compute_forces": "forces",
    "MDState": "integrate",
    "langevin_step": "integrate",
    "run_md": "integrate",
    "thermalize": "integrate",
    "minimize_energy": "minimize",
}


def __getattr__(name: str) -> Any:
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


def build_pair_force_fn(*args, **kwargs):
    """Lazy re-export of ``md.pair_force.build_pair_force_fn`` (the
    protein-scale pair-kernel force path), as the JAX package's
    ``md.build_pair_force_fn``."""
    from .pair_force import build_pair_force_fn as _fn

    return _fn(*args, **kwargs)


def load_amber_files(*args, **kwargs):
    """Lazy re-export of ``md.amber_params.load_amber_files`` (register
    user-supplied frcmod / parm.dat / OFF .lib parameter files), as the JAX
    package's ``md.load_amber_files``."""
    from .amber_params import load_amber_files as _fn

    return _fn(*args, **kwargs)


__all__ = [
    "System",
    "build_system",
    "potential_energy",
    "compute_forces",
    "MDState",
    "langevin_step",
    "run_md",
    "thermalize",
    "minimize_energy",
    "build_pair_force_fn",
    "load_amber_files",
]
