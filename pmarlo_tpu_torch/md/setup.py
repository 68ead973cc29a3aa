"""One implicit-solvent setup recipe for every entry point.

Port of the implicit half of ``pmarlo_tpu/md/setup.py``:
``build_implicit_setup`` builds the system, the X-H constraints, the
system with the constrained bonded terms stripped, and the force path
(the auto rule chooses between the dense analytic path and the pair
kernels). Minimization relaxes the FULL system (stiff X-H bonds kept);
MD runs the stripped system under SHAKE/RATTLE, as OpenMM's
``createSystem(constraints=HBonds)`` does. Explicit solvent is ROADMAP
queue A12.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional

import torch

from .._device import default_device
from ..io.pdb import read_pdb
from .forcefield import build_system
from .integrate import compose_bias, make_force_fn  # compose_bias: re-exported, JAX has it here
from .system import System
from .topology import _WATER_NAMES, Topology, build_topology

#: past this many atoms the auto rule picks the pair kernels on a CUDA
#: device (as the JAX rule does on a TPU)
PAIR_KERNEL_MIN_ATOMS = 600


def is_explicit_solvent(structure) -> bool:
    """A periodic box AND waters = explicit-solvent input."""
    has_waters = any(r.name in _WATER_NAMES for r in structure.residues)
    return getattr(structure, "box", None) is not None and has_waters


@dataclasses.dataclass
class ImplicitSetup:
    """Everything an implicit-solvent driver needs, built consistently."""

    system: System                 # full system (stiff X-H bonds kept)
    md_system: System              # constrained bonded terms stripped
    positions: torch.Tensor
    constraints: object            # ConstraintSpec or None
    force_fn: Optional[Callable]   # MD forces; None = the dense default
    force_path: str                # resolved "dense" | "pair_kernel"
    #: FULL-system forces for minimization; None = the dense default
    minimize_force_fn: Optional[Callable] = None


def build_implicit_setup(
    structure,
    *,
    implicit_solvent: bool = True,
    gb_model: str = "gbn2",
    constraints: Optional[str] = None,
    force_path: str = "auto",
    tile: int = 128,
    device=None,
) -> ImplicitSetup:
    """Build the implicit-solvent setup on ``device`` (``None``: the card
    when there is one, ``_device.default_device()``).

    Auto rule: the pair kernels (``md/pair_force.py``) past
    ``PAIR_KERNEL_MIN_ATOMS`` atoms on a CUDA device, the dense analytic
    path otherwise. The pair path builds the system without (N, N)
    tables (``dense_scales=False``); ``tile`` is its twins' row chunk."""
    if constraints not in (None, "none", "hbonds"):
        raise ValueError(
            f"constraints must be None|'none'|'hbonds', got {constraints!r}"
        )
    device = torch.device(device) if device is not None else default_device()
    if isinstance(structure, (str, Path)):
        structure = read_pdb(structure)
    topology = (structure if isinstance(structure, Topology)
                else build_topology(structure, keep_waters=False))
    if force_path == "auto":
        force_path = (
            "pair_kernel"
            if topology.n_atoms > PAIR_KERNEL_MIN_ATOMS and device.type == "cuda"
            else "dense"
        )
    if force_path not in ("dense", "pair_kernel"):
        raise ValueError(
            f"force_path must be auto|dense|pair_kernel, got {force_path!r}"
        )
    system, positions = build_system(
        topology, implicit_solvent=implicit_solvent, gb_model=gb_model,
        device=device, dense_scales=(force_path == "dense"),
    )

    cspec = None
    md_system = system
    if constraints == "hbonds":
        from .constraints import build_h_constraints, strip_constrained_bonded

        cspec = build_h_constraints(system)
        if cspec is not None:
            md_system = strip_constrained_bonded(system)

    minimize_force_fn = None
    if force_path == "pair_kernel":
        from .pair_force import build_pair_force_fn

        force_fn = build_pair_force_fn(md_system, tile=tile)
        minimize_force_fn = (force_fn if md_system is system
                             else build_pair_force_fn(system, tile=tile))
    elif cspec is None:
        force_fn = None   # the REMD driver's fused chunk or its twin
    else:
        force_fn = make_force_fn(md_system)
    return ImplicitSetup(
        system=system, md_system=md_system, positions=positions,
        constraints=cspec, force_fn=force_fn, force_path=force_path,
        minimize_force_fn=minimize_force_fn,
    )


def build_explicit_setup(*args, **kwargs):
    """Explicit solvent (periodic box, rigid water, cell lists)."""
    raise NotImplementedError(
        "explicit-solvent setup is not ported yet (ROADMAP queue A12)"
    )


__all__ = [
    "ImplicitSetup", "PAIR_KERNEL_MIN_ATOMS", "build_explicit_setup",
    "build_implicit_setup", "compose_bias", "is_explicit_solvent",
]
