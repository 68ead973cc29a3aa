"""One setup recipe per solvent model for every entry point.

Port of ``pmarlo_tpu/md/setup.py``. ``build_implicit_setup`` builds the
system, the X-H constraints, the system with the constrained bonded terms
stripped, and the force path (the auto rule chooses between the dense
analytic path and the pair kernels). ``build_explicit_setup`` does the
same for a solvated input (a box and waters): water detection, the
nonbonded engine (``resolve_nonbonded``: the dense minimum-image sweep
below 3,000 atoms, the cell list from there up, or the cell list with
smooth PME), rigid water and X-H constraints, and the two force functions. In both, minimization relaxes
the FULL system (stiff X-H bonds kept); MD runs the stripped system under
SHAKE/RATTLE, as OpenMM's ``createSystem(constraints=HBonds,
rigidWater=True)`` does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional, Tuple

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


@dataclasses.dataclass
class ExplicitSetup:
    """Everything an explicit-solvent entry point needs, built consistently."""

    system: System                 # full system (stiff X-H bonds kept)
    md_system: System              # constrained bonded terms stripped
    positions: torch.Tensor
    constraints: object            # SHAKE/RATTLE spec (or None)
    md_force_fn: Callable          # MD path (possibly the stateful cell sweep)
    minimize_force_fn: Optional[Callable]  # FULL-system sweep, or None
    nonbonded: str                 # resolved engine name


def resolve_nonbonded(
    nonbonded: str, n_atoms: int, *, require_cells: bool = False,
    triclinic: bool = False,
) -> str:
    """Resolve "auto" and validate. The dense sweep walks all N^2 pairs:
    past a few thousand atoms the O(N) cell list wins. ``require_cells``
    forces the cell path regardless of size; so does ``triclinic`` (the
    dense sweep does a per-axis minimum image on the box diagonal and would
    corrupt tilted-cell forces)."""
    if nonbonded == "auto":
        return ("cells" if (n_atoms >= 3000 or require_cells or triclinic)
                else "dense")
    if nonbonded not in ("dense", "cells", "pme"):
        raise ValueError(
            f"nonbonded must be auto|dense|cells|pme, got {nonbonded!r}"
        )
    if nonbonded == "dense" and triclinic:
        raise ValueError(
            "nonbonded='dense' is orthorhombic-only (per-axis minimum "
            "image); triclinic cells need 'cells' or 'pme'"
        )
    return nonbonded


def build_explicit_setup(
    structure,
    *,
    box: Optional[Tuple[float, float, float]] = None,
    tilt: Optional[Tuple[float, float, float]] = None,
    cutoff: float = 0.9,
    switch_distance: Optional[float] = None,
    nonbonded: str = "auto",
    require_cells: bool = False,
    dispersion_correction: bool = False,
    build_minimize_fn: bool = True,
    pme_precise: bool = False,
    device=None,
) -> ExplicitSetup:
    """Build the full explicit-solvent setup from a solvated structure on
    ``device`` (``None``: the card when there is one).

    ``box`` overrides the structure's CRYST1 (resume paths carry the evolved
    box); ``build_minimize_fn=False`` skips the FULL-system sweep's setup
    (resume paths never minimize). The minimize function aliases the MD
    function when stripping was a no-op (no constraints), so nothing is
    built twice. Neither sweep reads the (N, N) scale matrices
    (``build_system`` builds them up to 12,000 atoms for the autograd
    oracle): both work from the sparse exclusion lists. ``pme_precise`` is
    the PME engine's knob (df32 spreading) and needs ``nonbonded="pme"``."""
    if isinstance(structure, (str, Path)):
        structure = read_pdb(structure)
    system, positions = build_system(
        structure, box=box if box is not None else structure.box,
        tilt=(tilt if tilt is not None else getattr(structure, "tilt", None)),
        cutoff=cutoff, switch_distance=switch_distance, device=device,
    )
    nonbonded = resolve_nonbonded(
        nonbonded, system.n_atoms, require_cells=require_cells,
        triclinic=system.tilt is not None,
    )
    if pme_precise and nonbonded != "pme":
        raise ValueError(
            "pme_precise is the PME reciprocal path's knob; this system "
            f"resolved to nonbonded='{nonbonded}' (no reciprocal mesh) — "
            "request nonbonded='pme' or drop pme_precise"
        )

    from .constraints import build_h_constraints, strip_constrained_bonded

    constraints = build_h_constraints(system)
    # MD forces drop the bonded terms the constraints replace; minimization
    # keeps the FULL system: unconstrained relaxation needs the stiff bonds
    md_system = (strip_constrained_bonded(system)
                 if constraints is not None else system)

    if nonbonded == "dense":
        if dispersion_correction:
            raise ValueError(
                "dispersion_correction (NPT) needs the cell-list engine "
                "(nonbonded='cells' or 'pme'), not 'dense'"
            )
        from .periodic_force import build_periodic_force_fn as _build
    else:
        from .cell_force import build_cell_force_fn

        elec = "pme" if nonbonded == "pme" else "rf"

        def _build(sys_):
            return build_cell_force_fn(
                sys_, electrostatics=elec, dispersion_correction=dispersion_correction,
                pme_precise=pme_precise)

    md_force_fn = _build(md_system)
    minimize_force_fn = None
    if build_minimize_fn:
        minimize_force_fn = (md_force_fn if md_system is system
                             else _build(system))
    return ExplicitSetup(
        system=system, md_system=md_system, positions=positions,
        constraints=constraints, md_force_fn=md_force_fn,
        minimize_force_fn=minimize_force_fn, nonbonded=nonbonded,
    )


__all__ = [
    "ExplicitSetup", "ImplicitSetup", "PAIR_KERNEL_MIN_ATOMS",
    "build_explicit_setup", "build_implicit_setup", "compose_bias",
    "is_explicit_solvent", "resolve_nonbonded",
]
