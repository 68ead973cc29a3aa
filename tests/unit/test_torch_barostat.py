"""The Monte-Carlo barostat (``pmarlo_tpu_torch/md/barostat.py``) and the
cell sweep's dynamic-box entries (``md/cell_force.py``), against the JAX
package on the same seeded numpy inputs and against physics oracles.

- ``molecule_ids`` equal exactly; ``scale_positions`` to 1e-6 nm with rigid
  molecules.
- 40 volume moves with JAX's uniforms injected take JAX's decisions: the
  same ``accepted`` sequence, the box to 1e-6 relative, the same width
  after tuning (to 1e-6 relative).
- The ideal gas: ``<V> = (N + 1) kT / P`` within its statistical error
  (the mirror of ``tests/unit/test_barostat.py``), drawn from the port's
  own move stream.
- ``dynamic(x, build box)`` equals the static path (energy to 1e-6
  relative, forces to 1e-6 of the largest: the box tensor's shifts and
  influence function are float32, the build box's float64 rounded once);
  ``dynamic(x', box')``
  equals a fresh build at ``box'`` (JAX's ``test_dynamic_box_matches_static``
  oracle, on the plain sweep), reaction field and PME, orthorhombic and
  sheared; a box whose cell layers fall below the cutoff gives NaN, and a
  move into it is rejected.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.md import barostat
from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.system import system_from_numpy

jax = pytest.importorskip("jax")
jnp = jax.numpy

SHEAR = (0.12, 0.12, 0.12)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def solvated():
    """The JAX package's 325-atom solvated alanine and the port's system
    from its fields."""
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from test_torch_explicit_remd import _jax_structure, solvated_alanine

    s = solvated_alanine()
    jsys, jx = jax_build_system(_jax_structure(s), box=s.box, cutoff=0.45)
    return jsys, system_from_numpy(jsys.to_dict(), device="cpu"), np.asarray(jx, np.float32)


def test_molecule_ids_match_jax(solvated):
    from pmarlo_tpu.md.barostat import molecule_ids as jax_ids

    jsys, system, _ = solvated
    ids = barostat.molecule_ids(system)
    np.testing.assert_array_equal(ids, jax_ids(jsys))
    assert ids.dtype == np.int32
    n_waters = sum(1 for r in system.residue_names if r == "HOH") // 3
    assert ids.max() + 1 == 1 + n_waters        # the peptide and every water


def test_scale_positions_matches_jax_and_keeps_molecules_rigid(solvated):
    from pmarlo_tpu.md.barostat import scale_positions as jax_scale

    jsys, system, x = solvated
    ids = barostat.molecule_ids(system)
    n_mols = int(ids.max()) + 1
    masses = system.masses.numpy()
    got = barostat.scale_positions(torch.tensor(x), torch.tensor(1.03), ids, masses, n_mols)
    want = jax_scale(jnp.asarray(x), jnp.asarray(1.03, jnp.float32), ids, masses, n_mols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    for m in (0, 5, n_mols - 1):
        sel = ids == m
        d0 = np.linalg.norm(x[sel][:, None] - x[sel][None], axis=-1)
        d1 = np.linalg.norm(got.numpy()[sel][:, None] - got.numpy()[sel][None], axis=-1)
        np.testing.assert_allclose(d1, d0, atol=1e-5)
        w = masses[sel][:, None] / masses[sel].sum()
        np.testing.assert_allclose((w * got.numpy()[sel]).sum(0), 1.03 * (w * x[sel]).sum(0),
                                   rtol=1e-5)


def _box_energy(xp):
    """A box- and position-dependent energy, the same float32 arithmetic in
    both packages: a volume term and a tether of the fractional
    coordinates."""
    def energy(x, b):
        V = b[0] * b[1] * b[2]
        return 3000.0 / V + 20.0 * xp.sum((x / b - 0.5) ** 2)
    return energy


def test_volume_moves_take_jax_decisions_with_its_uniforms():
    from pmarlo_tpu.md import barostat as jb

    s, box = water_box_structure(3)
    x0 = s.coordinates().astype(np.float32)
    mol = np.repeat(np.arange(27), 3).astype(np.int32)
    masses = np.tile(np.asarray([15.999, 1.008, 1.008], np.float32), 27)
    kw = dict(pressure_bar=300.0, temperature_K=300.0)
    jmove = jax.jit(jb.make_volume_move(_box_energy(jnp), mol, masses, 27, **kw))
    tmove = barostat.make_volume_move(_box_energy(torch), mol, masses, 27, **kw)
    js = jb.init_barostat(jnp.asarray(box, jnp.float32), jax.random.PRNGKey(4))
    ts = barostat.init_barostat(box, seed=0, device="cpu")
    assert float(ts.dv) == pytest.approx(float(js.dv), rel=1e-6)
    jx, tx = jnp.asarray(x0), torch.tensor(x0)
    decisions = []
    for _ in range(40):
        _, k_dv, k_acc = jax.random.split(js.key, 3)
        u = (float(jax.random.uniform(k_dv, (), jnp.float32, -1.0, 1.0)),
             float(jax.random.uniform(k_acc, (), jnp.float32)))
        jx, js, jacc, je = jmove(jx, js)
        tx, ts, tacc, te = tmove(tx, ts, uniforms=u)
        decisions.append(bool(jacc))
        assert bool(tacc) == bool(jacc)
        np.testing.assert_allclose(ts.box.numpy(), np.asarray(js.box), rtol=1e-6)
        assert float(ts.dv) == pytest.approx(float(js.dv), rel=1e-6)
        assert float(te) == pytest.approx(float(je), rel=1e-5)
        assert ts.win_attempted == int(js.win_attempted)
        assert int(ts.win_accepted) == int(js.win_accepted)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    assert ts.n_attempted == int(js.n_attempted) == 40
    assert int(ts.n_accepted) == int(js.n_accepted) == sum(decisions)
    assert 0 < sum(decisions) < 40
    # the width was tuned four times
    assert float(ts.dv) != pytest.approx(0.01 * float(np.prod(np.float32(box))), rel=1e-3)


def test_ideal_gas_volume_distribution():
    """U == 0: <V> = (N_mol + 1) kT / P (the mirror of JAX's test, on the
    port's move stream)."""
    n_mol, T = 50, 300.0
    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * T
    v_target = 8.0
    p_bar = (n_mol + 1) * kT / v_target / barostat.BAR_TO_KJ_PER_MOL_NM3
    x = torch.rand((n_mol, 3), generator=torch.Generator().manual_seed(0)) * 2.0
    move = barostat.make_volume_move(lambda xx, bb: torch.zeros(()), np.arange(n_mol),
                                     np.full(n_mol, 18.0), n_mol, pressure_bar=p_bar,
                                     temperature_K=T)
    bs = barostat.init_barostat((2.0, 2.0, 2.0), seed=1, device="cpu")
    vols = []
    for _ in range(4000):
        x, bs, _, _ = move(x, bs)
        vols.append(bs.box.prod())
    vols = torch.stack(vols).numpy()
    assert np.isfinite(vols).all()
    mean_v = float(vols[1000:].mean())
    # relative fluctuation 1/sqrt(N + 1) ~ 14%; 3000 correlated samples
    assert abs(mean_v - v_target) / v_target < 0.12, mean_v
    acc = int(bs.n_accepted) / bs.n_attempted
    assert 0.2 < acc < 0.9, acc


def test_move_stream_is_a_pure_function_of_seed_and_move():
    from pmarlo_tpu_torch.md.integrate import gaussian_noise

    a = barostat.barostat_uniforms(7, 12, "cpu")
    b = barostat.barostat_uniforms(7, 12, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    draws = torch.stack([torch.stack(barostat.barostat_uniforms(7, k, "cpu"))
                         for k in range(200)])
    assert bool((draws[:, 0].abs() < 1.0).all() & (draws[:, 1] > 0.0).all()
                & (draws[:, 1] < 1.0).all())
    assert abs(float(draws[:, 0].mean())) < 0.15 and abs(float(draws[:, 1].mean()) - 0.5) < 0.1
    assert not torch.equal(torch.stack(barostat.barostat_uniforms(8, 12, "cpu")),
                           torch.stack(a))
    # the Langevin noise of the same seed is another stream
    z = gaussian_noise(torch.tensor(7, dtype=torch.int32), 12, 4)
    assert torch.isfinite(z).all()


def test_volume_move_reports_post_decision_energy():
    n = 8
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(0)) * 1.5

    def energy_fn(xx, bb):
        return 10.0 * (bb[0] * bb[1] * bb[2])

    move = barostat.make_volume_move(energy_fn, np.arange(n), np.full(n, 18.0), n,
                                     pressure_bar=1.0, temperature_K=300.0)
    bs = barostat.init_barostat((1.5, 1.5, 1.5), seed=7, device="cpu")
    for _ in range(10):
        x, bs, _, e_now = move(x, bs)
        assert float(e_now) == pytest.approx(float(energy_fn(x, bs.box)), rel=1e-5)


def _water(tilt=None, box_scale=1.0):
    s, box = water_box_structure(5)
    box = tuple(b * box_scale for b in box)
    tilt = None if tilt is None else tuple(t * box_scale for t in tilt)
    return build_system(s, box=box, tilt=tilt, cutoff=0.45, hydrogen_mass=None, device="cpu")


@pytest.mark.parametrize("electrostatics", ["rf", "pme"])
@pytest.mark.parametrize("tilt", [None, SHEAR], ids=["orthorhombic", "sheared"])
def test_dynamic_box_matches_static_and_a_fresh_build(electrostatics, tilt):
    system, x0 = _water(tilt)
    x = x0 + 0.01 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(3))
    fn = build_cell_force_fn(system, electrostatics=electrostatics, dispersion_correction=True)
    e0, f0 = fn(x)
    e1, f1 = fn.dynamic(x, torch.tensor(system.box))
    assert abs(float(e1) - float(e0)) <= 1e-6 * abs(float(e0))
    assert _rel(f1, f0) <= 1e-6
    st = fn.init_state_dynamic(x, system.box)
    e2, f2, st2 = fn.apply_dynamic(x, st, system.box)
    assert e2.shape == () and torch.equal(e2, e1) and torch.equal(f2, f1)
    assert torch.equal(st2.order, st.order)

    s = 1.02
    ids = barostat.molecule_ids(system)
    xs = barostat.scale_positions(x, torch.tensor(s), ids, system.masses, int(ids.max()) + 1)
    sys_s, _ = _water(tilt, box_scale=s)
    fn_s = build_cell_force_fn(sys_s, electrostatics=electrostatics, dispersion_correction=True)
    assert (fn_s.grid.nx, fn_s.grid.ny, fn_s.grid.nz) == (fn.grid.nx, fn.grid.ny, fn.grid.nz)
    if electrostatics == "pme":
        assert fn_s.pme_mesh_shape == fn.pme_mesh_shape
    e_ref, f_ref = fn_s(xs)
    box_s = torch.tensor(system.box, dtype=torch.float32) * s
    e_dyn, f_dyn = fn.dynamic(xs, box_s)
    assert abs(float(e_dyn) - float(e_ref)) <= 1e-5 * abs(float(e_ref))
    assert _rel(f_dyn, f_ref) <= 1e-4
    # the twin of the whole evaluation takes the box too
    e_tw, f_tw = fn.reference(xs, box_s)
    assert torch.equal(e_tw, e_dyn) and torch.equal(f_tw, f_dyn)

    # a box that breaks the cutoff cover poisons; a move into it rejects
    e_bad, f_bad = fn.dynamic(x, box_s * 0.5)
    assert math.isnan(float(e_bad)) and bool(torch.isnan(f_bad).all())
    move = barostat.make_volume_move(lambda xx, bb: fn.dynamic(xx, bb)[0], ids, system.masses,
                                     int(ids.max()) + 1, pressure_bar=1.0, temperature_K=300.0)
    v0 = float(np.prod(system.box))
    bs = barostat.init_barostat(system.box, seed=0, dv_initial=0.9 * v0, device="cpu")
    x_new, bs1, acc, e_now = move(x, bs, uniforms=(-0.97, 1e-6))
    assert not bool(acc) and torch.equal(x_new, x) and torch.equal(bs1.box, bs.box)
    assert float(e_now) == pytest.approx(float(e0), rel=1e-6)


def test_dispersion_tail_follows_the_box():
    """E(box) - E_notail(box) = 2 pi C / V on the dynamic path; forces are
    untouched."""
    from pmarlo_tpu_torch.md.dispersion import dispersion_coefficient

    system, x = _water()
    fn0 = build_cell_force_fn(system)
    fn1 = build_cell_force_fn(system, dispersion_correction=True)
    b = torch.tensor(system.box, dtype=torch.float32) * 1.01
    e0, f0 = fn0.dynamic(x, b)
    e1, f1 = fn1.dynamic(x, b)
    c2pi = 2.0 * math.pi * dispersion_coefficient(system)
    assert float(e1 - e0) == pytest.approx(c2pi / float(b.prod()), rel=1e-3)
    assert torch.equal(f0, f1)


def test_run_npt_refusals():
    system, x = _water()
    from pmarlo_tpu_torch.md.integrate import MDState
    from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn

    st = MDState(positions=x, velocities=torch.zeros_like(x),
                 seeds=torch.tensor(0, dtype=torch.int32))
    kw = dict(n_steps=20, dt=0.002, friction=1.0, temperature_K=300.0)
    with pytest.raises(ValueError, match="dynamic-box"):
        barostat.run_npt(system, st, force_fn=build_periodic_force_fn(
            dataclasses.replace(system, cutoff=0.8)), **kw)
    fn = build_cell_force_fn(system)
    with pytest.raises(ValueError, match="multiple of report_interval"):
        barostat.run_npt(system, st, force_fn=fn, report_interval=30, **kw)
    with pytest.raises(ValueError, match="multiple of barostat_interval"):
        barostat.run_npt(system, st, force_fn=fn, report_interval=10,
                         barostat_interval=4, **kw)
