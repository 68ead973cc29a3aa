"""``run_segment``: one single-temperature MD segment, end to end.

Port of ``pmarlo_tpu/md/simulation.py`` (the reference's prepare system ->
minimize -> thermalize -> step -> report): the same routes, checks and
result keys. The result's arrays are tensors on the run's device; the
``final_state`` / ``final_barostat_state`` handles are the port's own
(``md.integrate.MDState``, ``md.barostat.BarostatState``).

**Resume and the Philox streams.** JAX carries a PRNG key and folds a new
seed into it on resume. Here a state carries its Philox seeds and its step,
which is the noise counter (``md.integrate.gaussian_noise``). Resuming with
``seed=None`` keeps both, so a 200 + 200-step chain draws the noise of one
400-step run and gives its bits. Resuming with a seed re-keys the stream:
every replica's seed becomes ``fold_seed(old seed, seed)``, word 0 of
Philox4x32-10 with key ``(old seed, FOLD_KEY)`` and counter ``(seed low
word, seed high word, 0, 0)`` kept to 31 bits, and the step counter
continues, so walkers branched from one checkpoint with different seeds
draw different noise. The barostat's move stream continues with the
``BarostatState`` that is passed on.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._device import default_device
from ..constants import (
    BOLTZMANN_CONSTANT_KJ_PER_MOL,
    DEFAULT_FRICTION_PER_PS,
    DEFAULT_TEMPERATURE_K,
    DEFAULT_TIMESTEP_PS,
)
from ..io.trajectory import get_writer
from .integrate import MDState, philox4x32_10, run_md, thermalize
from .minimize import minimize_energy

#: second Philox key word of the re-keying rule ("FOLD")
FOLD_KEY = 0x464F4C44


def fold_seed(seeds: torch.Tensor, seed: int) -> torch.Tensor:
    """The seeds of a branch: word 0 of Philox4x32-10 with key ``(old seed,
    FOLD_KEY)`` and counter ``(seed low word, seed high word, 0, 0)``, kept
    to 31 bits, for each of ``seeds`` (int32, any shape)."""
    k0 = seeds.to(torch.int64) & 0xFFFFFFFF
    full = lambda v: torch.full_like(k0, int(v))  # noqa: E731
    w0, _, _, _ = philox4x32_10(full(int(seed) & 0xFFFFFFFF), full((int(seed) >> 32) & 0xFFFFFFFF),
                                full(0), full(0), k0, full(FOLD_KEY))
    return (w0 & 0x7FFFFFFF).to(torch.int32)


def run_segment(
    pdb_file: "str | Path",
    *,
    n_steps: int = 10_000,
    temperature_K: float = DEFAULT_TEMPERATURE_K,
    dt_ps: float = DEFAULT_TIMESTEP_PS,
    friction_per_ps: float = DEFAULT_FRICTION_PER_PS,
    report_interval: int = 100,
    minimize_iterations: int = 500,
    seed: Optional[int] = None,
    output_file: Optional["str | Path"] = None,
    bias_fn: Optional[Callable] = None,
    implicit_solvent: bool = True,
    gb_model: str = "gbn2",
    force_path: str = "auto",
    cutoff: float = 0.9,
    switch_distance: Optional[float] = None,
    nonbonded: str = "auto",
    pme_precise: bool = False,
    constraints: Optional[str] = None,
    ensemble: str = "nvt",
    pressure_bar: float = 1.0,
    barostat_interval: int = 25,
    initial_state: Optional[MDState] = None,
    initial_box=None,
    initial_barostat_state=None,
    device=None,
) -> Dict:
    """Run one Langevin segment on ``device`` (``None``: the card when
    there is one, ``_device.default_device()``). Returns a dict of tensors
    on that device and summary scalars.

    ``initial_state`` (the ``final_state`` of a previous result) continues
    a run: minimization and thermalization are skipped and the dynamics
    resume from its positions, velocities, Philox seeds and step (see the
    module docstring for ``seed`` on resume). For NPT continuation pass
    ``initial_barostat_state`` (the previous ``final_barostat_state``: box,
    tuned width, move stream) or at least ``initial_box``; resuming NPT
    with neither raises, because the grid would be built at the CRYST1 box
    while the positions sit at another volume.

    A solvated input (CRYST1 box + waters) takes the explicit-solvent
    periodic path: LJ + Coulomb at ``cutoff``, rigid water (TIP3P, or
    TIP4P-Ew / TIP5P with their virtual sites) and X-H constraints, the ``nonbonded`` engine ("dense": the O(N^2) sweep with
    reaction field; "cells": the cell-list sweep with reaction field;
    "pme": the cell-list sweep with smooth PME; "auto": cells from 3,000
    atoms, dense below), ``switch_distance`` for the LJ switch,
    ``pme_precise`` for df32 PME spreading. Other inputs take the implicit
    path (``md.setup.build_implicit_setup``: ``gb_model``, ``force_path``,
    ``constraints="hbonds"``).

    ``ensemble="nve"`` runs at zero friction from Maxwell-Boltzmann
    velocities and adds ``total_energy`` (F,). ``ensemble="npt"``
    (explicit solvent, cell engine) adds the Monte-Carlo barostat every
    ``barostat_interval`` steps at ``pressure_bar``, the dispersion tail,
    and the result keys ``box`` (F, 3), ``density_g_cm3`` (F,),
    ``barostat_acceptance``, ``final_box`` and ``final_barostat_state``.
    ``output_file`` writes the frames through ``io.trajectory.get_writer``
    (by suffix: .xtc, .dcd, .trr, .nc, else the npz store)."""
    if ensemble not in ("nvt", "nve", "npt"):
        raise ValueError(f"ensemble must be nvt|nve|npt, got {ensemble!r}")
    if constraints not in (None, "none", "hbonds"):
        raise ValueError(
            f"constraints must be None|'none'|'hbonds', got {constraints!r}"
        )
    device = torch.device(device) if device is not None else default_device()
    # zero friction = velocity Verlet (the O-step of BAOAB is identity)
    md_friction = 0.0 if ensemble == "nve" else friction_per_ps
    from ..io.cif import read_structure
    from .setup import build_explicit_setup, compose_bias, is_explicit_solvent

    structure = read_structure(pdb_file)
    start_seed = 2024 if seed is None else seed

    if is_explicit_solvent(structure):
        if constraints == "none":
            raise ValueError(
                "constraints='none' is not available on the explicit-"
                "solvent path: rigid TIP3P water requires SHAKE (the "
                "default, OpenMM HBonds + rigidWater semantics)"
            )
        if initial_barostat_state is not None:
            box = tuple(float(b) for b in initial_barostat_state.box.cpu().numpy())
        elif initial_box is not None:
            box = tuple(float(b) for b in np.asarray(initial_box))
        else:
            if ensemble == "npt" and initial_state is not None:
                raise ValueError(
                    "resuming ensemble='npt' needs initial_barostat_state "
                    "(or at least initial_box): the box evolved away from "
                    "the PDB's CRYST1 record during the previous segment"
                )
            box = structure.box
        tilt = getattr(structure, "tilt", None)
        if tilt is not None:
            # an evolved diagonal (isotropic NPT moves): the tilt scales by
            # the same factor, the tilt ratios being invariant
            s_fac = float(box[0]) / float(structure.box[0])
            for k in (1, 2):
                s_k = float(box[k]) / float(structure.box[k])
                if abs(s_k - s_fac) > 1e-6 * max(abs(s_fac), 1.0):
                    raise ValueError(
                        "triclinic resume box must be an ISOTROPIC "
                        "scale of the structure's CRYST1 cell (the "
                        "barostat only ever scales isotropically); got "
                        f"per-axis factors ({s_fac:.6f}, "
                        f"{float(box[1]) / float(structure.box[1]):.6f}, "
                        f"{float(box[2]) / float(structure.box[2]):.6f})"
                    )
            if abs(s_fac - 1.0) > 1e-12:
                tilt = tuple(float(t) * s_fac for t in tilt)
        # NPT gets the LJ tail term (OpenMM useDispersionCorrection): its
        # 1/V dependence sets the equilibrium density
        setup = build_explicit_setup(
            structure, box=box, tilt=tilt, cutoff=cutoff,
            switch_distance=switch_distance, nonbonded=nonbonded,
            pme_precise=pme_precise, require_cells=(ensemble == "npt"),
            dispersion_correction=(ensemble == "npt"),
            build_minimize_fn=initial_state is None, device=device,
        )
        system, positions = setup.system, setup.positions
        md_system, cspec = setup.md_system, setup.constraints
        md_base_fn = setup.md_force_fn
        _force_fn = (compose_bias(md_base_fn, bias_fn)
                     if bias_fn is not None else md_base_fn)
        # minimize through the same sweep MD uses (the FULL system's)
        if initial_state is not None:
            state = _check_resume_state(initial_state, system, seed, device)
            e_min = float("nan")
        else:
            x_min, e_min = minimize_energy(
                system, positions, max_iterations=minimize_iterations,
                bias_fn=bias_fn, force_fn=setup.minimize_force_fn,
            )
            state = thermalize(system, x_min, _generator(start_seed, device), temperature_K)
        if ensemble == "npt":
            if setup.nonbonded == "dense":
                raise ValueError(
                    "ensemble='npt' needs the cell-list engine "
                    "(nonbonded='cells' or 'pme')"
                )
            from .barostat import run_npt

            final_state, bstate, frames = run_npt(
                md_system, state, n_steps=n_steps, dt=dt_ps,
                friction=friction_per_ps, temperature_K=temperature_K,
                pressure_bar=pressure_bar, barostat_interval=barostat_interval,
                report_interval=report_interval, force_fn=md_base_fn,
                constraints=cspec, full_system=system, seed=start_seed,
                barostat_state=initial_barostat_state, bias_fn=bias_fn,
            )
            result = _package_result(
                system, final_state, frames, e_min, n_steps, dt_ps,
                temperature_K, report_interval, output_file,
                box_trace=frames["box"],
            )
            result["box"] = frames["box"]
            result["density_g_cm3"] = frames["density_g_cm3"]
            result["barostat_acceptance"] = (
                int(bstate.n_accepted) / max(float(bstate.n_attempted), 1.0))
            result["final_box"] = bstate.box.cpu().numpy()
            # continuation handle: box + tuned width + move stream
            result["final_barostat_state"] = bstate
            return result
        final_state, frames = run_md(
            system, state, n_steps=n_steps, dt=dt_ps, friction=md_friction,
            temperature_K=temperature_K, report_interval=report_interval,
            force_fn=_force_fn, constraints=cspec,
        )
        result = _package_result(
            system, final_state, frames, e_min, n_steps, dt_ps,
            temperature_K, report_interval, output_file,
        )
        if ensemble == "nve":
            _attach_total_energy(result, system, cspec)
        return result

    if ensemble == "npt":
        raise ValueError(
            "ensemble='npt' requires an explicit-solvent periodic input "
            "(CRYST1 box + waters); this structure routed to the "
            "implicit-solvent path"
        )
    if switch_distance is not None:
        raise ValueError(
            "switch_distance applies to the explicit-solvent periodic "
            "path only; this structure routed to the implicit-solvent "
            "path (NoCutoff, nothing to switch)"
        )
    if pme_precise:
        raise ValueError(
            "pme_precise applies to the explicit-solvent PME path only; "
            "this structure routed to the implicit-solvent path "
            "(no reciprocal mesh)"
        )
    from .setup import build_implicit_setup

    isetup = build_implicit_setup(
        structure, implicit_solvent=implicit_solvent, gb_model=gb_model,
        constraints=constraints, force_path=force_path, device=device,
    )
    system, positions = isetup.system, isetup.positions
    hspec, base_fn = isetup.constraints, isetup.force_fn
    force_fn = (compose_bias(base_fn, bias_fn)
                if base_fn is not None and bias_fn is not None else base_fn)
    if initial_state is not None:
        state = _check_resume_state(initial_state, system, seed, device)
        e_min = float("nan")
    else:
        x_min, e_min = minimize_energy(
            system, positions, max_iterations=minimize_iterations,
            bias_fn=bias_fn, force_fn=isetup.minimize_force_fn,
        )
        state = thermalize(system, x_min, _generator(start_seed, device), temperature_K)
    final_state, frames = run_md(
        system, state, n_steps=n_steps, dt=dt_ps, friction=md_friction,
        temperature_K=temperature_K, report_interval=report_interval,
        # the pair path composes the bias into force_fn; bias_fn only goes
        # through when run_md builds the dense path itself
        bias_fn=bias_fn if force_fn is None else None,
        force_fn=force_fn, constraints=hspec,
    )
    result = _package_result(
        system, final_state, frames, e_min, n_steps, dt_ps,
        temperature_K, report_interval, output_file,
    )
    if ensemble == "nve":
        _attach_total_energy(result, system, hspec)
    return result


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _check_resume_state(initial_state, system, seed, device):
    """Validate a resume state against the built system and move it to the
    run's device; re-key its stream by ``seed`` when one is given."""
    if not isinstance(initial_state, MDState):
        raise ValueError(
            f"initial_state must be an MDState (a previous result's "
            f"['final_state'] entry, not the result dict itself); got "
            f"{type(initial_state).__name__}"
        )
    shp = tuple(initial_state.positions.shape)
    vshp = tuple(initial_state.velocities.shape)
    if shp != (system.n_atoms, 3) or vshp != shp:
        raise ValueError(
            f"initial_state has positions {shp} / velocities {vshp}, but "
            f"this structure builds a {system.n_atoms}-atom system — "
            "resume states must come from a previous run_segment on the "
            "same input"
        )
    state = dataclasses.replace(
        initial_state, positions=initial_state.positions.to(device),
        velocities=initial_state.velocities.to(device),
        seeds=initial_state.seeds.to(device))
    if seed is None:
        return state
    return dataclasses.replace(state, seeds=fold_seed(state.seeds, seed))


def _attach_total_energy(result, system, spec) -> None:
    """total_energy (F,) = PE + KE, the kinetic energy recovered from the
    reported temperature with the NVE reporter's 3 (N - n_vsites) - 3 -
    n_con degrees of freedom (``run_md`` at friction 0 removes the COM;
    massless virtual sites carry none)."""
    from .constraints import n_constraints
    from .vsites import n_vsites

    n_con = n_constraints(spec) if spec is not None else 0
    n_dof = max(3 * (system.n_atoms - n_vsites(system)) - 3 - int(n_con), 1)
    ke = 0.5 * n_dof * BOLTZMANN_CONSTANT_KJ_PER_MOL * result["temperature"]
    result["total_energy"] = result["potential_energy"] + ke


def _package_result(system, final_state, frames, e_min, n_steps, dt_ps,
                    temperature_K, report_interval, output_file,
                    box_trace=None):
    result = {
        "system": system,
        "final_state": final_state,
        "positions": frames["positions"],          # (F, N, 3) on the device
        "potential_energy": frames["potential_energy"],
        "temperature": frames["temperature"],
        "minimized_energy": float(e_min),
        "n_steps": n_steps,
        "dt_ps": dt_ps,
        "temperature_K": temperature_K,
    }
    if output_file is not None:
        # by suffix: .dcd/.xtc/.trr/.nc writers (cell records from the box,
        # tilt and per-frame box trace), else the npz store
        writer = get_writer(
            Path(output_file),
            metadata={
                "temperature_K": temperature_K,
                "dt_ps": dt_ps,
                "report_interval": report_interval,
                "n_steps": n_steps,
                "atom_names": list(system.atom_names),
                "residue_names": list(system.residue_names),
                "residue_ids": list(system.residue_ids),
                "box": (list(system.box) if system.box is not None else None),
                "tilt": (list(system.tilt) if system.tilt is not None else None),
                "box_trace": (box_trace.detach().cpu().numpy().tolist()
                              if box_trace is not None else None),
            },
        )
        writer.write_frames(frames["positions"].detach().cpu().numpy())
        writer.close()
        result["output_file"] = Path(output_file)
    return result


__all__ = ["FOLD_KEY", "fold_seed", "run_segment"]
