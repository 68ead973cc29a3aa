"""The explicit-solvent slice as a whole (``md/setup.py
build_explicit_setup``, stateful force functions in ``md/integrate.py``,
the explicit branch of ``remd/remd.py``) against the JAX package, on
alanine dipeptide in 5^3 lattice waters (325 atoms, box 1.65 nm, cutoff
0.5 nm: three cell layers an axis) and on the shipped solvated chignolin.

JAX runs on the CPU with its Pallas kernels in interpret mode. Tolerances:
setup energies to 1e-5 relative and forces to 1e-4 of max |F|; 20
constrained steps at friction 0 to 1e-4 nm; swap decisions identical when
energies and uniforms are injected.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.io.pdb import PDBStructure, read_pdb
from pmarlo_tpu_torch.md.cell_force import CellForce
from pmarlo_tpu_torch.md.cells import free_skin
from pmarlo_tpu_torch.md.constraints import (
    CompositeConstraintSpec,
    build_h_constraints,
    constraint_violation,
)
from pmarlo_tpu_torch.md.integrate import (
    MDState,
    compose_bias,
    run_md,
    stateful_entries,
    thermalize,
)
from pmarlo_tpu_torch.md.minimize import minimize_energy
from pmarlo_tpu_torch.md.periodic_force import PeriodicForce
from pmarlo_tpu_torch.md.setup import (
    build_explicit_setup,
    is_explicit_solvent,
    resolve_nonbonded,
)
from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange, run_replica_exchange

ROOT = Path(__file__).resolve().parents[2]
SOLVATED = ROOT / "examples" / "outputs" / "explicit_solvent" / "chignolin_solvated.pdb"
CUTOFF = 0.5
REMD = dict(n_replicas=3, t_min=300.0, t_max=330.0, exchange_frequency=10,
            report_interval=5, dt_ps=0.002, seed=0)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def solvated_alanine():
    """Alanine dipeptide in the middle of a 5^3 water lattice (waters
    within 0.28 nm of a solute atom left out), box 1.65 nm."""
    waters, box = water_box_structure(5)
    solute = alanine_dipeptide_structure()
    xyz = np.array([a.xyz for r in solute.residues for a in r.atoms])
    shift = 0.5 * box[0] - xyz.mean(0)
    for r in solute.residues:
        for a in r.atoms:
            a.xyz = tuple(float(v) for v in np.asarray(a.xyz) + shift)
    xyz = xyz + shift
    kept = [w for w in waters.residues
            if min(np.linalg.norm(xyz - np.asarray(a.xyz), axis=1).min()
                   for a in w.atoms) > 0.28]
    return PDBStructure(residues=solute.residues + kept, box=box)


def _jax_structure(s):
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure as JaxStructure

    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    return JaxStructure(residues=residues, box=s.box)


def _assert_close(e, f, e_ref, f_ref, what):
    e, f, e_ref, f_ref = (np.asarray(a, np.float64) for a in (e, f, e_ref, f_ref))
    assert np.abs(e - e_ref).max() <= 1e-5 * np.abs(e_ref).max(), what
    assert np.abs(f - f_ref).max() <= 1e-4 * np.abs(f_ref).max(), what


@pytest.fixture(scope="module", params=["dense", "cells"])
def setups(request):
    """The port's and JAX's explicit setup of the same structure through
    the same engine, and positions relaxed by the port's minimizer."""
    from pmarlo_tpu.md.setup import build_explicit_setup as jax_setup

    torch.set_num_threads(2)
    s = solvated_alanine()
    ours = build_explicit_setup(s, cutoff=CUTOFF, nonbonded=request.param, device="cpu")
    theirs = jax_setup(_jax_structure(s), cutoff=CUTOFF, nonbonded=request.param,
                       interpret=True)
    x_min, _ = minimize_energy(ours.system, ours.positions,
                               force_fn=ours.minimize_force_fn, max_iterations=60)
    return request.param, ours, theirs, x_min


RESOLVE = [
    ("auto", 2315, {}), ("auto", 2999, {}), ("auto", 3000, {}), ("auto", 27783, {}),
    ("auto", 100, dict(require_cells=True)), ("auto", 100, dict(triclinic=True)),
    ("dense", 50000, {}), ("cells", 100, {}), ("pme", 100, {}),
    ("cells", 100, dict(triclinic=True)), ("dense", 100, dict(triclinic=True)),
    ("ewald", 100, {}),
]


@pytest.mark.parametrize("nonbonded,n,kw", RESOLVE)
def test_resolve_nonbonded_matches_jax(nonbonded, n, kw):
    """Every branch of the engine rule gives JAX's answer or JAX's error."""
    from pmarlo_tpu.md.setup import resolve_nonbonded as jax_resolve

    try:
        want = jax_resolve(nonbonded, n, **kw)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            resolve_nonbonded(nonbonded, n, **kw)
        assert str(got.value) == str(err)
    else:
        assert resolve_nonbonded(nonbonded, n, **kw) == want


def test_setup_fields_match_jax(setups):
    """Resolved engine, system arrays, constraint counts, the stripped MD
    system, and both force functions' numbers on the setup positions."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.constraints import n_constraints as jax_n_constraints

    engine, ours, theirs, _ = setups
    assert ours.nonbonded == theirs.nonbonded == engine
    assert is_explicit_solvent(solvated_alanine())
    assert ours.system.n_atoms == theirs.system.n_atoms == 325
    assert ours.system.box == tuple(theirs.system.box) and ours.system.cutoff == CUTOFF
    for name in ("masses", "charges", "lj_sigma", "lj_eps"):
        np.testing.assert_allclose(getattr(ours.system, name).numpy(),
                                   np.asarray(getattr(theirs.system, name)), rtol=1e-6)
    np.testing.assert_allclose(ours.positions.numpy(), np.asarray(theirs.positions),
                               atol=1e-6)
    assert isinstance(ours.constraints, CompositeConstraintSpec)
    assert ours.constraints.n_constraints == jax_n_constraints(theirs.constraints)
    for name in ("bond_idx", "angle_idx"):
        np.testing.assert_array_equal(getattr(ours.md_system, name).numpy(),
                                      np.asarray(getattr(theirs.md_system, name)))
    assert ours.md_system is not ours.system
    assert ours.md_force_fn.system is ours.md_system
    assert ours.minimize_force_fn.system is ours.system
    kind = PeriodicForce if engine == "dense" else CellForce
    assert isinstance(ours.md_force_fn, kind) and isinstance(ours.minimize_force_fn, kind)
    if engine == "cells":
        g, jg = ours.md_force_fn.grid, theirs.md_force_fn.grid
        assert (g.nx, g.ny, g.nz) == (jg.nx, jg.ny, jg.nz)
        assert free_skin(g) == pytest.approx(theirs.md_force_fn.skin)
        assert hasattr(ours.md_force_fn, "apply_batched")
    x = ours.positions
    for fn, jfn, what in ((ours.md_force_fn, theirs.md_force_fn, "MD"),
                          (ours.minimize_force_fn, theirs.minimize_force_fn, "minimize")):
        e, f = fn(x)
        ej, fj = jfn(jnp.asarray(x.numpy()))
        _assert_close(e, f, float(ej), np.asarray(fj), f"{engine} {what} force function")


def test_minimize_through_the_full_system(setups):
    """FIRE through the FULL system's sweep lowers the energy; the relaxed
    structure's energy is JAX's at the same positions."""
    import jax.numpy as jnp

    _, ours, theirs, x_min = setups
    e0, _ = ours.minimize_force_fn(ours.positions)
    e1, f1 = ours.minimize_force_fn(x_min)
    assert float(e1) < float(e0) and bool(torch.isfinite(x_min).all())
    ej, fj = theirs.minimize_force_fn(jnp.asarray(x_min.numpy()))
    _assert_close(e1, f1, float(ej), np.asarray(fj), "energy of the relaxed structure")


def test_constrained_steps_match_jax(setups):
    """20 steps of constrained ``langevin_step`` at friction 0, 2 fs,
    through each package's MD force function (``run_md``, two frames; the
    cell engine through its stateful entries on both sides): positions to
    1e-4 nm, frame energies to 1e-5 relative, temperatures to 1e-3."""
    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.md.integrate import MDState as JaxMDState
    from pmarlo_tpu.md.integrate import run_md as jax_run_md

    _, ours, theirs, x_min = setups
    x0 = x_min.numpy()
    rng = np.random.default_rng(1)
    m = ours.system.masses.numpy()
    v0 = (np.sqrt(BOLTZMANN_CONSTANT_KJ_PER_MOL * 300.0 / m)[:, None]
          * rng.standard_normal(x0.shape)).astype(np.float32)
    kw = dict(n_steps=20, dt=0.002, friction=0.0, temperature_K=300.0, report_interval=10)
    jstate = JaxMDState(positions=jnp.asarray(x0), velocities=jnp.asarray(v0),
                        key=jax.random.PRNGKey(0), step=jnp.asarray(0, jnp.int32))
    jfinal, jframes = jax_run_md(theirs.system, jstate, force_fn=theirs.md_force_fn,
                                 constraints=theirs.constraints, **kw)
    state = MDState(positions=torch.from_numpy(x0), velocities=torch.from_numpy(v0),
                    seeds=torch.tensor(0, dtype=torch.int32), step=0)
    final, frames = run_md(ours.system, state, force_fn=ours.md_force_fn,
                           constraints=ours.constraints, **kw)
    assert final.step == 20 and frames["positions"].shape == (2,) + x0.shape
    np.testing.assert_allclose(final.positions.numpy(), np.asarray(jfinal.positions),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(frames["positions"].numpy(),
                               np.asarray(jframes["positions"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(frames["potential_energy"].numpy(),
                               np.asarray(jframes["potential_energy"]), rtol=1e-5)
    np.testing.assert_allclose(frames["temperature"].numpy(),
                               np.asarray(jframes["temperature"]), rtol=1e-3)
    assert float(constraint_violation(ours.constraints, final.positions)) <= 1e-5


def test_stateful_and_plain_paths_agree(setups):
    """``run_md`` threading the cell sweep's neighbour state gives the
    trajectory of the same function called afresh every step;
    ``compose_bias`` keeps the stateful entries and adds the bias
    to both."""
    engine, ours, _, x_min = setups
    fn = ours.md_force_fn
    if engine == "dense":
        assert stateful_entries(fn, x_min) == (None, None)
        assert not hasattr(compose_bias(fn, lambda x: x.sum()), "apply")
        return
    gen = torch.Generator().manual_seed(3)
    state = thermalize(ours.system, x_min, gen, 300.0)
    kw = dict(n_steps=20, dt=0.002, friction=0.0, temperature_K=300.0, report_interval=10,
              constraints=ours.constraints)
    final_s, frames_s = run_md(ours.system, state, force_fn=fn, **kw)
    final_p, frames_p = run_md(ours.system, state, force_fn=lambda x: fn(x), **kw)
    # both bin afresh at every step: the same numbers
    assert torch.equal(final_s.positions, final_p.positions)
    assert torch.equal(frames_s["potential_energy"], frames_p["potential_energy"])

    def bias(x):
        return 10.0 * (x[..., 0, :] ** 2).sum(-1)

    biased = compose_bias(fn, bias)
    for name in ("init_state", "apply", "init_state_batched", "apply_batched"):
        assert hasattr(biased, name)
    e0, f0 = fn(x_min)
    e1, f1, st = biased.apply(x_min, biased.init_state(x_min))
    assert float(e1 - e0) == pytest.approx(float(bias(x_min)), rel=1e-3)
    np.testing.assert_allclose((f1 - f0)[0].numpy(), (-20.0 * x_min[0]).numpy(), rtol=1e-3)
    assert torch.equal(f1[1:], f0[1:]) and st.xw.shape == (1,) + tuple(x_min.shape)


@pytest.mark.parametrize("parity", [0, 1])
def test_explicit_swaps_match_jax(setups, parity):
    """The explicit REMD runner's swaps against JAX's ``_attempt_swaps`` on the
    same injected energies, identities, configurations and uniforms:
    identical decisions, identities and positions."""
    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.md.integrate import MDState as JaxMDState
    from pmarlo_tpu.remd.remd import RemdConfig as JaxRemdConfig
    from pmarlo_tpu.remd.remd import ReplicaExchange as JaxReplicaExchange

    _, ours, theirs, x_min = setups
    R, n = 4, 325
    kw = dict(REMD, n_replicas=R)
    jremd = JaxReplicaExchange(theirs.system, jnp.asarray(x_min.numpy()),
                               JaxRemdConfig(**kw), force_fn=theirs.md_force_fn,
                               constraints=theirs.constraints, minimize=False)
    tremd = ReplicaExchange(ours.system, x_min, RemdConfig(**kw), device="cpu",
                            force_fn=ours.md_force_fn, constraints=ours.constraints,
                            minimize=False)
    rng = np.random.default_rng(31 + parity)
    pos = rng.normal(0.0, 1.0, (R, n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (R, n, 3)).astype(np.float32)
    # explicit-solvent energies: tens of thousands of kJ/mol, gaps of ~100
    energies = rng.normal(-15_000.0, 60.0, R).astype(np.float32)
    ids = rng.permutation(R).astype(np.int32)
    key = jax.random.PRNGKey(300 + parity)
    u = np.array(jax.random.uniform(key, (R,)))
    jstate = JaxMDState(positions=jnp.asarray(pos), velocities=jnp.asarray(vel),
                        key=jax.random.split(key, R), step=jnp.zeros(R, jnp.int32))
    js_new, jids, jacc = jremd._attempt_swaps(
        jstate, jnp.asarray(energies), jnp.asarray(ids), jnp.asarray(parity), key)
    tstate = MDState(positions=torch.from_numpy(pos), velocities=torch.from_numpy(vel),
                     seeds=torch.arange(R, dtype=torch.int32), step=0)
    ts_new, tids, tacc = tremd._attempt_swaps(
        tstate, torch.from_numpy(energies), torch.from_numpy(ids), parity,
        torch.from_numpy(u))
    np.testing.assert_array_equal(np.asarray(jacc), tacc.numpy())
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
    np.testing.assert_array_equal(np.asarray(js_new.positions), ts_new.positions.numpy())
    np.testing.assert_allclose(ts_new.velocities.numpy(), np.asarray(js_new.velocities),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("nonbonded", ["auto", "cells"])
def test_run_replica_exchange_on_a_solvated_input(nonbonded):
    """The one-call entry on the small solvated input, on the CPU: the box
    and the waters route it to the explicit path, "auto" resolves to the
    dense sweep, frames are finite and on the constraint manifold, swaps
    are attempted, the kinetic temperature counts the constrained degrees
    of freedom."""
    s = solvated_alanine()
    # the cell sweep's plain version loops over 27 neighbour cells: fewer steps
    n_steps = 40 if nonbonded == "auto" else 20
    res, system = run_replica_exchange(
        s, n_steps=n_steps, config=RemdConfig(**REMD), device="cpu", cutoff=CUTOFF,
        nonbonded=nonbonded)
    assert system.box is not None and system.n_atoms == 325
    assert res.positions.shape == (n_steps // 5, 3, 325, 3)
    assert np.isfinite(res.positions).all()
    assert np.isfinite(res.potential_energy).all()
    spec = build_h_constraints(system)
    assert float(constraint_violation(spec, torch.as_tensor(res.positions))) <= 1e-4
    assert res.acceptance_matrix.shape == (2,)
    ratio = res.kinetic_temperature[-1] / res.temperatures
    assert ((ratio > 0.5) & (ratio < 1.5)).all()


def test_explicit_entry_refusals():
    """What the explicit entry refuses: no constraints, a ``mesh`` that is
    not a ``DeviceMesh`` (sharded explicit REMD over real ranks is in
    ``test_torch_parallel_remd.py``), a switch distance on an implicit
    input, ``pme_precise`` without the PME engine."""
    s = solvated_alanine()
    cfg = RemdConfig(**REMD)
    with pytest.raises(ValueError, match="rigid TIP3P water requires SHAKE"):
        run_replica_exchange(s, n_steps=10, config=cfg, device="cpu", cutoff=CUTOFF,
                             constraints="none")
    with pytest.raises(ValueError, match="pme_precise"):
        build_explicit_setup(s, cutoff=CUTOFF, nonbonded="cells", pme_precise=True,
                             device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_replica_exchange(s, n_steps=10, config=cfg, device="cpu", cutoff=CUTOFF,
                             mesh=object())
    with pytest.raises(ValueError, match="switch_distance"):
        run_replica_exchange(alanine_dipeptide_structure(), n_steps=10, config=cfg,
                             device="cpu", switch_distance=0.4)
    with pytest.raises(ValueError, match="dispersion_correction"):
        build_explicit_setup(s, cutoff=CUTOFF, nonbonded="dense",
                             dispersion_correction=True, device="cpu")
    with pytest.raises(ValueError, match="auto\\|dense\\|cells\\|pme"):
        build_explicit_setup(s, cutoff=CUTOFF, nonbonded="ewald", device="cpu")


def test_solvated_chignolin_setup_at_full_width():
    """The shipped 2,315-atom input: "auto" resolves to the dense sweep,
    the cell engine gives the same energy and forces (the same physics by
    two routes), every water and X-H bond is constrained."""
    st = read_pdb(SOLVATED)
    assert is_explicit_solvent(st)
    dense = build_explicit_setup(st, device="cpu", build_minimize_fn=False)
    cells = build_explicit_setup(st, device="cpu", nonbonded="cells",
                                 build_minimize_fn=False)
    assert dense.nonbonded == "dense" and cells.nonbonded == "cells"
    assert dense.minimize_force_fn is None and dense.system.n_atoms == 2315
    assert dense.system.cutoff == 0.9 and dense.system.switch_distance is None
    spec = dense.constraints
    n_waters = sum(r.name == "HOH" for r in st.residues)
    assert spec.water.n_waters == n_waters and spec.protein.n_constraints > 50
    assert spec.n_constraints == spec.protein.n_constraints + 3 * n_waters
    g = cells.md_force_fn.grid
    assert (g.nx, g.ny, g.nz) == (3, 3, 2)
    assert free_skin(g) == pytest.approx(2.8549 / 3 - 0.9)
    x = dense.positions + torch.as_tensor(
        np.random.default_rng(5).normal(0.0, 0.01, (2315, 3)), dtype=torch.float32)
    e_d, f_d = dense.md_force_fn(x)
    e_c, f_c = cells.md_force_fn(x)
    _assert_close(e_c, f_c, e_d, f_d, "cells against dense")
    sw = build_explicit_setup(st, device="cpu", switch_distance=0.8,
                              build_minimize_fn=False)
    assert sw.system.switch_distance == 0.8
    e_s, _ = sw.md_force_fn(x)
    assert abs(float(e_s - e_d)) > 1.0
