"""``run_segment`` of the port (``pmarlo_tpu_torch/md/simulation.py``) as a
whole, against the JAX package's on the same inputs.

- Implicit alanine dipeptide, ``ensemble="nve"``, 100 steps from one state
  carried into both packages (``md_state_from_numpy``): frames to 1e-3 nm,
  energies to 1e-4 relative (no noise enters at friction 0).
- Explicit: ``run_segment(nonbonded="pme", ensemble="npt")`` on a 192-atom
  water box for 100 steps; its force function at the start and at the end
  (positions and box) held against JAX's dense PME oracle (energy 1e-5
  relative, forces 1e-4 of the largest); finite frames, an acceptance in
  [0, 1], the result's keys those of JAX's NPT result, and a trajectory
  file whose frames read back.
- Resume: a 200 + 200-step chain equals one 400-step run bit for bit on
  the CPU (Langevin noise continues on the step counter), also under NPT
  (the move stream continues on the barostat's counter); a seed on resume
  re-keys the stream, so branches differ; NPT resume needs the barostat
  state (mirrors of ``test_md_integration.py`` and ``test_barostat.py``).
"""

import numpy as np
import pytest
import torch

import pmarlo_tpu_torch
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.io.pdb import write_pdb
from pmarlo_tpu_torch.md.integrate import md_state_from_numpy

jax = pytest.importorskip("jax")
jnp = jax.numpy

#: the keys of the JAX package's NPT result (``md/simulation.py``)
JAX_NPT_KEYS = {
    "system", "final_state", "positions", "potential_energy", "temperature",
    "minimized_energy", "n_steps", "dt_ps", "temperature_K", "output_file", "box",
    "density_g_cm3", "barostat_acceptance", "final_box", "final_barostat_state",
}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pdb(path, s, box=None):
    atoms = [a for r in s.residues for a in r.atoms]
    return str(write_pdb(path, s.coordinates(), [a.name for a in atoms],
                         [a.resname for a in atoms], [a.resid for a in atoms], box=box))


@pytest.fixture(scope="module")
def alanine_pdb(tmp_path_factory):
    return _pdb(tmp_path_factory.mktemp("ala") / "ala.pdb", alanine_dipeptide_structure())


@pytest.fixture(scope="module")
def water_pdb(tmp_path_factory):
    s, box = water_box_structure(4)
    return _pdb(tmp_path_factory.mktemp("wat") / "wat.pdb", s, box=box)


def test_implicit_nve_segment_matches_jax_from_one_state(alanine_pdb):
    from pmarlo_tpu.io.cif import read_structure
    from pmarlo_tpu.md.integrate import MDState as JState
    from pmarlo_tpu.md.setup import build_implicit_setup
    from pmarlo_tpu.md.simulation import run_segment as jax_run_segment

    isetup = build_implicit_setup(read_structure(alanine_pdb))
    jsys = isetup.system
    rng = np.random.default_rng(9)
    x = (np.asarray(isetup.positions) + rng.normal(0.0, 0.005, (jsys.n_atoms, 3))
         ).astype(np.float32)
    m = np.asarray(jsys.masses, np.float64)[:, None]
    v = (rng.normal(size=x.shape) * np.sqrt(2.494 / m)).astype(np.float32)
    kw = dict(n_steps=100, report_interval=20, ensemble="nve")
    jres = jax_run_segment(alanine_pdb, initial_state=JState(
        positions=jnp.asarray(x), velocities=jnp.asarray(v), key=jax.random.PRNGKey(0),
        step=jnp.int32(0)), **kw)
    tres = pmarlo_tpu_torch.run_segment(
        alanine_pdb, initial_state=md_state_from_numpy(x, v, 0, seed=0, device="cpu"),
        device="cpu", **kw)
    assert tres["positions"].shape == tuple(np.shape(jres["positions"])) == (5, 22, 3)
    np.testing.assert_allclose(tres["positions"].numpy(), np.asarray(jres["positions"]),
                               atol=1e-3, rtol=0)
    for key in ("potential_energy", "total_energy"):
        want = np.asarray(jres[key], np.float64)
        got = tres[key].double().numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), key
    assert tres["final_state"].step == 100 and np.isnan(tres["minimized_energy"])


def _oracle_vs_port(result, x, box):
    """The port's PME force function at ``x`` in ``box`` (the dynamic
    entry of a static build, unshifted real space) against JAX's dense PME
    oracle of a JAX system built at ``box``."""
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from test_torch_cell_force import _jax_structure
    from test_torch_pme import jax_pme_oracle

    s, _ = water_box_structure(4)
    jsys, _ = jax_build_system(_jax_structure(s), box=tuple(float(b) for b in box),
                               cutoff=0.4, hydrogen_mass=None)
    fn = build_cell_force_fn(result["system"], electrostatics="pme", ewald_shift=False)
    e, f = fn.dynamic(torch.tensor(x), torch.tensor(box, dtype=torch.float32))
    e_ref, f_ref = jax_pme_oracle(jsys, x, fn.pme_mesh_shape, fn.pme_order)
    assert abs(float(e) - e_ref) <= 1e-5 * abs(e_ref), (float(e), e_ref)
    assert np.abs(f.numpy() - f_ref).max() <= 1e-4 * np.abs(f_ref).max()


def test_explicit_pme_npt_segment(water_pdb, tmp_path):
    from pmarlo_tpu_torch.io.trajectory import TrajectoryReader

    out = tmp_path / "traj.xtc"
    res = pmarlo_tpu_torch.run_segment(
        water_pdb, n_steps=100, report_interval=20, barostat_interval=5, ensemble="npt",
        nonbonded="pme", cutoff=0.4, minimize_iterations=40, seed=3, output_file=out,
        device="cpu")
    assert set(res) == JAX_NPT_KEYS
    F = 5
    assert res["positions"].shape == (F, 192, 3) and res["box"].shape == (F, 3)
    assert res["density_g_cm3"].shape == (F,) and res["temperature"].shape == (F,)
    assert bool(torch.isfinite(res["positions"]).all())
    assert bool(torch.isfinite(res["potential_energy"]).all())
    assert 0.0 <= res["barostat_acceptance"] <= 1.0
    bs = res["final_barostat_state"]
    assert bs.n_attempted == 20 and torch.equal(bs.box, res["box"][-1])
    np.testing.assert_array_equal(res["final_box"], res["box"][-1].numpy())
    mass = float(res["system"].masses.double().sum())
    vol = res["box"].double().prod(-1)
    np.testing.assert_allclose(res["density_g_cm3"].double().numpy(),
                               (1.66053906660e-3 * mass / vol).numpy(), rtol=1e-6)
    # the force function at the start (CRYST1 box) and at the end
    s, box = water_box_structure(4)
    _oracle_vs_port(res, s.coordinates().astype(np.float32), box)
    _oracle_vs_port(res, res["positions"][-1].numpy(), res["box"][-1].numpy())
    frames = TrajectoryReader(out).load()
    np.testing.assert_allclose(frames, res["positions"].numpy(), atol=2e-3)


def _same_state(a, b):
    return (torch.equal(a.positions, b.positions) and torch.equal(a.velocities, b.velocities)
            and torch.equal(a.seeds, b.seeds) and a.step == b.step)


def test_resume_chain_is_bitwise_and_seeds_branch(alanine_pdb):
    kw = dict(report_interval=100, minimize_iterations=30, seed=11, device="cpu")
    one = pmarlo_tpu_torch.run_segment(alanine_pdb, n_steps=400, **kw)
    first = pmarlo_tpu_torch.run_segment(alanine_pdb, n_steps=200, **kw)
    kw.pop("seed")
    second = pmarlo_tpu_torch.run_segment(alanine_pdb, n_steps=200,
                                          initial_state=first["final_state"], **kw)
    assert _same_state(second["final_state"], one["final_state"])
    assert torch.equal(second["positions"], one["positions"][2:])
    a = pmarlo_tpu_torch.run_segment(alanine_pdb, n_steps=100, seed=5,
                                     initial_state=first["final_state"], **kw)
    b = pmarlo_tpu_torch.run_segment(alanine_pdb, n_steps=100, seed=6,
                                     initial_state=first["final_state"], **kw)
    assert not torch.equal(a["final_state"].seeds, b["final_state"].seeds)
    assert not torch.equal(a["positions"], b["positions"])
    assert a["final_state"].step == 300
    with pytest.raises(ValueError, match="MDState"):
        pmarlo_tpu_torch.run_segment(alanine_pdb, n_steps=100, initial_state=first, **kw)


def test_npt_resume_continues_box_and_move_stream(water_pdb):
    kw = dict(report_interval=10, barostat_interval=5, ensemble="npt", nonbonded="pme",
              cutoff=0.4, device="cpu")
    one = pmarlo_tpu_torch.run_segment(water_pdb, n_steps=40, minimize_iterations=20, seed=3,
                                       **kw)
    first = pmarlo_tpu_torch.run_segment(water_pdb, n_steps=20, minimize_iterations=20,
                                         seed=3, **kw)
    with pytest.raises(ValueError, match="initial_barostat_state"):
        pmarlo_tpu_torch.run_segment(water_pdb, n_steps=20,
                                     initial_state=first["final_state"], **kw)
    second = pmarlo_tpu_torch.run_segment(
        water_pdb, n_steps=20, initial_state=first["final_state"],
        initial_barostat_state=first["final_barostat_state"], **kw)
    bs = second["final_barostat_state"]
    assert bs.n_attempted == first["final_barostat_state"].n_attempted + 4 == 8
    assert _same_state(second["final_state"], one["final_state"])
    assert torch.equal(second["box"], one["box"][2:])
    assert torch.equal(bs.dv, one["final_barostat_state"].dv)


def test_segment_refusals(alanine_pdb, water_pdb):
    kw = dict(n_steps=10, report_interval=10, device="cpu")
    with pytest.raises(ValueError, match="explicit-solvent"):
        pmarlo_tpu_torch.run_segment(alanine_pdb, ensemble="npt", **kw)
    with pytest.raises(ValueError, match="ensemble must be"):
        pmarlo_tpu_torch.run_segment(alanine_pdb, ensemble="nvk", **kw)
    with pytest.raises(ValueError, match="pme_precise"):
        pmarlo_tpu_torch.run_segment(alanine_pdb, pme_precise=True, **kw)
    with pytest.raises(ValueError, match="cell-list engine"):
        pmarlo_tpu_torch.run_segment(water_pdb, ensemble="npt", nonbonded="dense",
                                     cutoff=0.4, **kw)
    with pytest.raises(ValueError, match="rigid TIP3P"):
        pmarlo_tpu_torch.run_segment(water_pdb, constraints="none", cutoff=0.4, **kw)
