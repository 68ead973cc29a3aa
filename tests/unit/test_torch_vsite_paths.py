"""Virtual-site water on every explicit path of the port, against the JAX
package on the CPU, for TIP4P-Ew and TIP5P boxes:

* each site-correct force function against JAX's wrapped counterpart,
  energies to 1e-5 relative and forces to 1e-4 of max |F|: the dense
  periodic sweep (row 8's plain version vs the Pallas periodic kernel in
  interpret mode), the cell sweep in reaction-field and in PME mode
  (row 9's plain version vs the Pallas cell kernel), PME under a box
  tensor (``dynamic``);
* the stride-4 and stride-5 rigid-water solve against JAX's ``shake`` /
  ``rattle`` at 1e-6 nm from an MD step's displacement;
* ``langevin_step`` at friction 0 (the autograd route with the
  expansion composed in, rigid water) step for step against JAX for 20
  steps, within 1e-4 nm;
* FIRE minimization against JAX's final energy at 1e-4;
* 200-step ``run_segment`` NVT, NPT (PME) and NVE runs on the 27-water
  boxes: finite, sites on their parents in every frame, the temperature
  and ``total_energy`` with JAX's degrees of freedom;
* a 2-replica explicit REMD of two exchange windows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.md.constraints import (
    build_h_constraints,
    constraint_violation,
    rattle,
    shake,
    strip_constrained_bonded,
)
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.vsites import VirtualSites, n_vsites
from tests.unit.test_torch_vsites import jax_box, port_structure

CUTOFF = 0.6             # a 4^3 box is 1.34 nm wide: more than 2 x 0.6
MODELS = ["tip4pew", "tip5p"]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_close(e, f, e_ref, f_ref, what):
    e, f, e_ref, f_ref = (np.asarray(a, np.float64) for a in (e, f, e_ref, f_ref))
    assert np.abs(e - e_ref).max() <= 1e-5 * np.abs(e_ref).max(), what
    assert np.abs(f - f_ref).max() <= 1e-4 * np.abs(f_ref).max(), what


def _jax_structure(s):
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure

    return PDBStructure(residues=[PDBResidue(
        name=r.name, resid=r.resid, chain=r.chain, atoms=[PDBAtom(
            name=a.name, resname=a.resname, resid=a.resid, chain=a.chain, xyz=a.xyz,
            element=a.element) for a in r.atoms]) for r in s.residues], box=s.box)


@pytest.fixture(scope="module", params=MODELS)
def relaxed(request):
    """64 randomly turned waters of ``model`` relaxed by 100 FIRE steps
    through the port's dense periodic sweep: ``(model, JAX system, port
    system, positions (N, 3) float32)``."""
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn

    s, box = water_box_structure(4, water_model=request.param, seed=0)
    tsys, x0 = build_system(s, box=box, cutoff=CUTOFF, hydrogen_mass=None, device="cpu")
    jsys, _ = jax_build_system(_jax_structure(s), box=box, cutoff=CUTOFF, hydrogen_mass=None)
    x, _ = minimize_energy(tsys, x0, force_fn=build_periodic_force_fn(tsys), max_iterations=100)
    return request.param, jsys, tsys, x.numpy()


def _noisy(x, seed, sigma=0.002):
    rng = np.random.default_rng(seed)
    return (np.asarray(x, np.float64) + rng.normal(0.0, sigma, np.shape(x))).astype(np.float32)


@pytest.mark.parametrize("engine", ["periodic", "cells_rf", "cells_pme"])
def test_force_functions_match_jax(relaxed, engine):
    import jax.numpy as jnp

    _, jsys, tsys, x = relaxed
    if engine == "periodic":
        from pmarlo_tpu.md.pallas_periodic import build_periodic_force_fn as jax_build

        from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn

        fn, jfn = build_periodic_force_fn(tsys), jax_build(jsys, interpret=True)
    else:
        from pmarlo_tpu.md.pallas_cells import build_cell_force_fn as jax_build

        from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn

        elec = engine.split("_")[1]
        fn = build_cell_force_fn(tsys, electrostatics=elec)
        jfn = jax_build(jsys, electrostatics=elec, interpret=True)
    xs = _noisy(x, seed=1)
    e, f = fn(torch.tensor(xs))
    je, jf = jfn(jnp.asarray(xs))
    _assert_close(e, f, float(je), np.asarray(jf), engine)
    sites = tsys.vsite_idx[:, 0].long()
    assert (f[sites] == 0.0).all()
    # a stale site row changes nothing: the evaluation re-derives it
    stale = torch.tensor(xs)
    stale[sites] += 0.05
    e2, f2 = fn(stale)
    assert torch.equal(e2, e) and torch.equal(f2, f)
    # the plain version of the whole evaluation is the same function
    if engine != "periodic":
        er, fr = fn.reference(torch.tensor(xs))
        assert torch.equal(er, e) and torch.equal(fr, f)


def test_pme_under_a_box_tensor_matches_jax(relaxed):
    """The NPT entries: ``dynamic`` and ``apply_dynamic`` in a box 1.5%
    larger, the molecules (sites with their water) scaled rigidly."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_cells import build_cell_force_fn as jax_build

    from pmarlo_tpu_torch.md import barostat
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn

    _, jsys, tsys, x = relaxed
    fn = build_cell_force_fn(tsys, electrostatics="pme", dispersion_correction=True)
    jfn = jax_build(jsys, electrostatics="pme", dispersion_correction=True, interpret=True)
    ids = barostat.molecule_ids(tsys)
    assert int(ids.max()) + 1 == 64          # each site joins its water
    box = torch.tensor(tsys.box, dtype=torch.float32) * 1.015
    vs = VirtualSites.from_system(tsys)
    xs = barostat.scale_positions(vs.expand(torch.tensor(_noisy(x, seed=2))), 1.015, ids,
                                  tsys.masses, 64)
    assert float((vs.expand(xs) - xs).abs().max()) <= 1e-6
    e, f = fn.dynamic(xs, box)
    je, jf = jfn.dynamic(jnp.asarray(xs.numpy()), jnp.asarray(box.numpy()))
    _assert_close(e, f, float(je), np.asarray(jf), "dynamic")
    e2, f2, _ = fn.apply_dynamic(xs, fn.init_state_dynamic(xs, box), box)
    assert torch.equal(e2, e) and torch.equal(f2, f)


def test_ewald_exclusion_correction_is_finite_at_the_site_distance(relaxed):
    """The erf part of the excluded intra-water pairs, taken off by the
    pair-list correction, at the O-M (0.0125 nm) and O-L (0.070 nm)
    distances in float32: finite and within 1e-4 of its float64 value."""
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn

    _, _, tsys, x = relaxed
    fn = build_cell_force_fn(tsys, electrostatics="pme")
    xb = torch.tensor(x)[None]
    e32, f32 = fn.correction(xb)
    e64, f64 = fn.correction(xb.double())
    assert bool(torch.isfinite(e32).all()) and bool(torch.isfinite(f32).all())
    assert float((e32.double() - e64).abs().max()) <= 1e-4 * float(e64.abs().max())
    assert float((f32.double() - f64).abs().max()) <= 1e-4 * float(f64.abs().max())


def _jax_spec(jsys):
    from pmarlo_tpu.md.constraints import build_h_constraints as jax_build

    return jax_build(jsys)


def test_rigid_water_solve_matches_jax(relaxed):
    import jax.numpy as jnp
    from pmarlo_tpu.md.constraints import rattle as jax_rattle
    from pmarlo_tpu.md.constraints import shake as jax_shake

    model, jsys, tsys, x = relaxed
    spec, jspec = build_h_constraints(tsys), _jax_spec(jsys)
    stride = 4 if model == "tip4pew" else 5
    assert spec.water.stride == jspec.water.stride == stride
    assert spec.water.n_waters == 64 and spec.n_constraints == 192
    rng = np.random.default_rng(3)
    v = rng.normal(0.0, 0.5, x.shape).astype(np.float32)
    v[tsys.vsite_idx[:, 0].long().numpy()] = 0.0
    x_new = (x + 0.002 * v).astype(np.float32)
    got = shake(spec, torch.tensor(x_new), torch.tensor(x)).numpy()
    want = np.asarray(jax_shake(jspec, jnp.asarray(x_new), jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-6
    assert float(constraint_violation(spec, torch.tensor(got))) <= 1e-5
    # the site rows ride along untouched
    sites = tsys.vsite_idx[:, 0].long().numpy()
    assert np.array_equal(got[sites], x_new[sites])
    vr = rattle(spec, torch.tensor(v), torch.tensor(got)).numpy()
    vr_j = np.asarray(jax_rattle(jspec, jnp.asarray(v), jnp.asarray(got)))
    assert np.abs(vr - vr_j).max() <= 1e-5 * np.abs(v).max()
    assert np.array_equal(vr[sites], v[sites])


def test_langevin_steps_match_jax_at_zero_friction(relaxed):
    """20 g-BAOAB steps at friction 0 through the autograd route (the
    expansion composed into the dense periodic energy), rigid water, the
    sites re-derived after every step: positions within 1e-4 nm of JAX's,
    site velocities 0."""
    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.md.constraints import strip_constrained_bonded as jax_strip
    from pmarlo_tpu.md.integrate import MDState as JaxState
    from pmarlo_tpu.md.integrate import langevin_step as jax_step

    from pmarlo_tpu_torch.md.integrate import langevin_step, md_state_from_numpy

    _, jsys, tsys, x = relaxed
    spec, jspec = build_h_constraints(tsys), _jax_spec(jsys)
    md_sys, jmd = strip_constrained_bonded(tsys), jax_strip(jsys)
    rng = np.random.default_rng(4)
    v = rng.normal(0.0, 0.3, x.shape).astype(np.float32)
    sites = tsys.vsite_idx[:, 0].long().numpy()
    v[sites] = 0.0
    v = rattle(spec, torch.tensor(v), torch.tensor(x)).numpy()
    kw = dict(dt=0.002, friction=0.0, temperature_K=300.0)
    step = jax.jit(lambda st: jax_step(jmd, st, constraints=jspec, **kw))
    js = JaxState(positions=jnp.asarray(x), velocities=jnp.asarray(v),
                  key=jax.random.PRNGKey(0), step=jnp.asarray(0, jnp.int32))
    ts = md_state_from_numpy(x, v, 0, seed=1, device="cpu")
    phys = np.setdiff1d(np.arange(tsys.n_atoms), sites)
    for _ in range(20):
        js, je = step(js)
        ts, te = langevin_step(md_sys, ts, constraints=spec, **kw)
    xp, xj = ts.positions.numpy(), np.asarray(js.positions)
    assert np.abs(xp - xj).max() <= 1e-4
    assert np.abs(ts.velocities.numpy()[phys] - np.asarray(js.velocities)[phys]).max() <= 1e-3
    assert (ts.velocities[torch.as_tensor(sites)] == 0.0).all()
    assert abs(float(te) - float(je)) <= 1e-4 * abs(float(je))
    assert float((VirtualSites.from_system(tsys).expand(ts.positions)
                  - ts.positions).abs().max()) == 0.0


def test_fire_matches_jax_final_energy(relaxed):
    """50 FIRE iterations through the autograd route from a perturbed
    start: the port's final energy within 1e-4 of JAX's, the sites on
    their parents."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.minimize import minimize_energy as jax_minimize

    from pmarlo_tpu_torch.md.minimize import minimize_energy

    _, jsys, tsys, x = relaxed
    x0 = _noisy(x, seed=5, sigma=0.01)
    xt, et = minimize_energy(tsys, torch.tensor(x0), max_iterations=50)
    xj, ej = jax_minimize(jsys, jnp.asarray(x0), max_iterations=50)
    assert abs(float(et) - float(ej)) <= 1e-4 * abs(float(ej))
    assert float((VirtualSites.from_system(tsys).expand(xt) - xt).abs().max()) <= 1e-6


def _pdb(tmp_path, model):
    from pmarlo_tpu_torch.io.pdb import write_pdb

    js, box = jax_box(model)
    s = port_structure(js, box)
    atoms = [a for r in s.residues for a in r.atoms]
    path = tmp_path / f"{model}.pdb"
    write_pdb(str(path), np.asarray([a.xyz for a in atoms]), [a.name for a in atoms],
              [a.resname for a in atoms], [a.resid for a in atoms], box=box)
    return path


def _sites_on_parents(res) -> float:
    vs = VirtualSites.from_system(res["system"])
    x = res["positions"]
    return float((vs.expand(x) - x).abs().max())


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("ensemble", ["nvt", "npt", "nve"])
def test_run_segment_takes_site_water(tmp_path, model, ensemble):
    """200 steps of ``run_segment`` on the JAX tests' 27-water box: frames
    and energies finite, the sites on their parents in every frame, the
    rigid waters on the manifold, the reported temperature and (NVE)
    ``total_energy`` with JAX's degree-of-freedom count."""
    from pmarlo_tpu.md.simulation import _attach_total_energy as jax_total_energy

    from pmarlo_tpu_torch.md.integrate import instantaneous_temperature
    from pmarlo_tpu_torch.md.simulation import run_segment

    pdb = _pdb(tmp_path, model)
    kw = dict(n_steps=200, report_interval=50, cutoff=0.5, minimize_iterations=50, seed=3,
              dt_ps=0.002, device="cpu", ensemble=ensemble,
              nonbonded="pme" if ensemble == "npt" else "dense")
    if ensemble == "npt":
        kw.update(barostat_interval=25)
    res = run_segment(pdb, **kw)
    system = res["system"]
    assert n_vsites(system) == (27 if model == "tip4pew" else 54)
    assert bool(torch.isfinite(res["positions"]).all())
    assert bool(torch.isfinite(res["potential_energy"]).all())
    assert _sites_on_parents(res) <= 1e-6
    spec = build_h_constraints(system)
    assert float(constraint_violation(spec, res["positions"])) <= 1e-4
    T = res["temperature"]
    assert bool(((T > 100.0) & (T < 600.0)).all()), T
    state = res["final_state"]
    sites = system.vsite_idx[:, 0].long()
    assert (state.velocities[sites] == 0.0).all()
    # the temperature divides by 3 (N - sites) - constraints [- 3 in NVE]
    n_dof = 3 * (system.n_atoms - n_vsites(system)) - spec.n_constraints
    n_dof -= 3 if ensemble == "nve" else 0
    t_now = instantaneous_temperature(system, state.velocities, spec.n_constraints,
                                      remove_com=ensemble == "nve")
    assert float(t_now) == pytest.approx(
        2.0 * float((0.5 * system.masses[:, None] * state.velocities**2).sum())
        / (n_dof * 0.00831446261815324), rel=1e-5)
    if ensemble == "nve":
        want = {"potential_energy": res["potential_energy"].numpy(),
                "temperature": T.numpy()}
        from pmarlo_tpu.md.forcefield import build_system as jax_build_system

        jsys, _ = jax_build_system(_jax_structure(port_structure(jax_box(model)[0],
                                                                  system.box)),
                                   box=system.box, cutoff=0.5)
        jax_total_energy(want, jsys, spec.n_constraints)
        np.testing.assert_allclose(res["total_energy"].numpy(),
                                   np.asarray(want["total_energy"]), rtol=1e-6)
    if ensemble == "npt":
        assert 0.0 <= res["barostat_acceptance"] <= 1.0
        assert bool(torch.isfinite(res["density_g_cm3"]).all())


def test_explicit_remd_takes_site_water(tmp_path):
    """2 replicas of the TIP4P-Ew box, two exchange windows: finite frames
    on the constraint manifold, sites on their parents, one swap pair."""
    from pmarlo_tpu_torch.io.pdb import read_pdb
    from pmarlo_tpu_torch.remd.remd import RemdConfig, run_replica_exchange

    s = read_pdb(_pdb(tmp_path, "tip4pew"))
    cfg = RemdConfig(n_replicas=2, t_min=300.0, t_max=320.0, exchange_frequency=10,
                     report_interval=5, dt_ps=0.002, seed=0)
    res, system = run_replica_exchange(s, n_steps=20, config=cfg, device="cpu", cutoff=0.5)
    assert n_vsites(system) == 27
    x = torch.as_tensor(res.positions)
    assert x.shape == (4, 2, 108, 3) and bool(torch.isfinite(x).all())
    assert np.isfinite(res.potential_energy).all()
    vs = VirtualSites.from_system(system)
    assert float((vs.expand(x) - x).abs().max()) <= 1e-6
    assert float(constraint_violation(build_h_constraints(system), x)) <= 1e-4
    assert res.acceptance_matrix.shape == (1,)
    ratio = res.kinetic_temperature[-1] / res.temperatures
    assert ((ratio > 0.3) & (ratio < 2.0)).all()


def test_dense_autograd_oracle_through_the_expansion(relaxed):
    """The analytic dense path (``make_force_fn``, wrapped) and the
    autograd route agree with the periodic sweep's evaluation on a site
    system; the dense analytic parameters take the system."""
    from pmarlo_tpu_torch.md.integrate import make_force_fn
    from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn
    from pmarlo_tpu_torch.md.vsites import expanded_energy_and_forces

    _, _, tsys, x = relaxed
    xs = torch.tensor(_noisy(x, seed=6))
    e, f = build_periodic_force_fn(tsys)(xs)
    eo, fo = expanded_energy_and_forces(tsys, xs.double())
    _assert_close(e, f, eo, fo, "autograd oracle")
    assert (fo[tsys.vsite_idx[:, 0].long()] == 0.0).all()
    nb = dataclasses.replace(tsys, box=None)
    ea, fa = make_force_fn(nb)(xs)
    eg, fg = expanded_energy_and_forces(nb, xs.double())
    _assert_close(ea, fa, eg, fg, "analytic dense, no box")
