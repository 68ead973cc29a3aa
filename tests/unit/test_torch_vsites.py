"""Virtual-site water in the port (``pmarlo_tpu_torch/md/vsites.py``)
against the JAX package, the mirror of ``test_tip4pew.py`` and
``test_tip5p.py`` on their 27-water boxes (random orientations):

* ``build_system`` field by field (masses, charges, sigma / epsilon, the
  site index, weight and kind arrays, the exclusions);
* the linear (TIP4P-Ew M) and out-of-plane (TIP5P L1 / L2) geometry
  against JAX ``vsite_positions`` at 1e-6 nm;
* the closed-form spread against JAX ``vsite_spread`` (its ``jax.vjp``
  for kind 1) and against torch autograd of the expansion, at 1e-6 of
  unit-scale forces;
* ``kind=None`` against an all-zero kind;
* central finite differences of the wrapped energy on the physical
  degrees of freedom, and zero force on the site rows;
* ``n_vsites`` and the temperature's degrees of freedom against JAX;
* zero site velocities through ``initialize_velocities``, ``thermalize``
  and ``run_md``.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.io.pdb import PDBAtom, PDBResidue, PDBStructure
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.system import system_from_numpy
from pmarlo_tpu_torch.md.vsites import (
    VirtualSites,
    n_vsites,
    vsite_positions,
    vsite_spread,
    wrap_force_fn,
)

SITE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_structure(s, box=None):
    """The port's ``PDBStructure`` of a JAX package structure."""
    return PDBStructure(residues=[PDBResidue(
        name=r.name, resid=r.resid, chain=r.chain, atoms=[PDBAtom(
            name=a.name, resname=a.resname, resid=a.resid, chain=a.chain, xyz=a.xyz,
            element=a.element) for a in r.atoms]) for r in s.residues],
        box=box if box is not None else s.box)


def jax_box(model):
    """The JAX tests' 27-water box of ``model``: (JAX structure, box)."""
    if model == "tip4pew":
        from tests.unit.test_tip4pew import _t4_box

        return _t4_box(3)
    from tests.unit.test_tip5p import _t5_box

    return _t5_box(3)


@pytest.fixture(scope="module", params=["tip4pew", "tip5p"])
def boxes(request):
    """``(model, JAX system, JAX positions, port system, port positions)``."""
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s, box = jax_box(request.param)
    jsys, jx = jax_build_system(s, box=box, cutoff=0.5, hydrogen_mass=None)
    tsys, tx = build_system(port_structure(s, box), box=box, cutoff=0.5,
                            hydrogen_mass=None, device="cpu")
    return request.param, jsys, np.asarray(jx, np.float32), tsys, tx


def _perturbed(x, seed, sigma=0.01):
    rng = np.random.default_rng(seed)
    return (np.asarray(x, np.float64) + rng.normal(0.0, sigma, np.shape(x))).astype(np.float32)


def test_topology_and_parameters_match_jax(boxes):
    model, jsys, _, tsys, _ = boxes
    jd, td = jsys.to_dict(), tsys.to_dict()
    per_water = 4 if model == "tip4pew" else 5
    assert tsys.n_atoms == per_water * 27
    assert n_vsites(tsys) == (27 if model == "tip4pew" else 54)
    for key in ("masses", "charges", "lj_sigma", "lj_eps", "vsite_weights"):
        np.testing.assert_allclose(td[key], np.asarray(jd[key]), rtol=1e-6, atol=0.0,
                                   err_msg=key)
    for key in ("vsite_idx", "excl12_idx", "pair14_idx", "bond_idx", "angle_idx"):
        np.testing.assert_array_equal(td[key], np.asarray(jd[key]), err_msg=key)
    if model == "tip4pew":
        assert jd["vsite_kind"] is None and td["vsite_kind"] is None
    else:
        np.testing.assert_array_equal(td["vsite_kind"], np.asarray(jd["vsite_kind"]))
        assert (td["vsite_kind"] == 1).all()
    sites = td["vsite_idx"][:, 0]
    assert (td["masses"][sites] == 0.0).all() and (td["lj_eps"][sites] == 0.0).all()
    # every intra-water pair excluded: 6 for four sites, 10 for five
    excl = set(map(tuple, td["excl12_idx"]))
    first = [(a, b) for a in range(per_water) for b in range(a + 1, per_water)]
    assert len(first) == (6 if model == "tip4pew" else 10)
    assert all(p in excl for p in first)
    # the carry of a JAX system gives the same tensors
    carried = system_from_numpy(jd, device="cpu")
    assert torch.equal(carried.vsite_idx, tsys.vsite_idx)
    assert (carried.vsite_kind is None) == (tsys.vsite_kind is None)


def test_site_geometry_matches_jax(boxes):
    import jax.numpy as jnp
    from pmarlo_tpu.md.vsites import vsite_positions as jax_vsite_positions

    model, jsys, jx, tsys, _ = boxes
    x = _perturbed(jx, seed=3)
    want = np.asarray(jax_vsite_positions(jnp.asarray(x), jsys.vsite_idx, jsys.vsite_weights,
                                          jsys.vsite_kind))
    got = vsite_positions(torch.tensor(x), tsys.vsite_idx, tsys.vsite_weights,
                          tsys.vsite_kind).numpy()
    assert np.abs(got - want).max() <= SITE_ATOL
    # the physical rows pass through untouched; a batch gives each frame's
    sites = tsys.vsite_idx[:, 0].long().numpy()
    phys = np.setdiff1d(np.arange(tsys.n_atoms), sites)
    assert np.array_equal(got[phys], x[phys])
    xb = np.stack([x, _perturbed(jx, seed=4)])
    vs = VirtualSites.from_system(tsys)
    gb = vs.expand(torch.tensor(xb)).numpy()
    assert np.array_equal(gb[0], got)
    # the template geometry: O-M 0.0125 nm on the bisector, O-L 0.070 nm
    o = tsys.vsite_idx[:, 1].long().numpy()
    d = np.linalg.norm(got[sites] - got[o], axis=-1)
    x0 = vsite_positions(torch.tensor(jx), tsys.vsite_idx, tsys.vsite_weights,
                         tsys.vsite_kind).numpy()
    d0 = np.linalg.norm(x0[sites] - x0[o], axis=-1)
    np.testing.assert_allclose(d0, 0.0125 if model == "tip4pew" else 0.070, atol=3e-4)
    assert np.isfinite(d).all()


def test_spread_matches_jax_and_autograd(boxes):
    import jax.numpy as jnp
    from pmarlo_tpu.md.vsites import vsite_spread as jax_vsite_spread

    _, jsys, jx, tsys, _ = boxes
    x = _perturbed(jx, seed=5)
    rng = np.random.default_rng(6)
    g = rng.normal(size=x.shape).astype(np.float32)
    xe = vsite_positions(torch.tensor(x), tsys.vsite_idx, tsys.vsite_weights, tsys.vsite_kind)
    got = vsite_spread(torch.tensor(g), tsys.vsite_idx, tsys.vsite_weights, tsys.vsite_kind,
                       xe).numpy()
    want = np.asarray(jax_vsite_spread(jnp.asarray(g), jsys.vsite_idx, jsys.vsite_weights,
                                       jsys.vsite_kind, jnp.asarray(xe.numpy())))
    assert np.abs(got - want).max() <= SITE_ATOL
    # autograd of <g, expand(x)> is J^T g: the closed form is its transpose
    y = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    out = vsite_positions(y, tsys.vsite_idx, tsys.vsite_weights, tsys.vsite_kind)
    (jt,) = torch.autograd.grad((out * torch.tensor(g, dtype=torch.float64)).sum(), y)
    spread64 = vsite_spread(torch.tensor(g, dtype=torch.float64), tsys.vsite_idx,
                            tsys.vsite_weights, tsys.vsite_kind, out.detach())
    assert float((spread64 - jt).abs().max()) <= SITE_ATOL
    assert (got[tsys.vsite_idx[:, 0].long().numpy()] == 0.0).all()
    if tsys.vsite_kind is not None:
        with pytest.raises(ValueError, match="positions"):
            vsite_spread(torch.tensor(g), tsys.vsite_idx, tsys.vsite_weights, tsys.vsite_kind)


def test_kind_none_matches_the_linear_path(boxes):
    _, _, jx, tsys, _ = boxes
    x = torch.tensor(_perturbed(jx, seed=7))
    kind0 = torch.zeros(tsys.vsite_idx.shape[0], dtype=torch.int32)
    a = vsite_positions(x, tsys.vsite_idx, tsys.vsite_weights)
    b = vsite_positions(x, tsys.vsite_idx, tsys.vsite_weights, kind0)
    assert torch.equal(a, b)
    f = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    sa = vsite_spread(f, tsys.vsite_idx, tsys.vsite_weights)
    sb = vsite_spread(f, tsys.vsite_idx, tsys.vsite_weights, kind0, a)
    assert float((sa - sb).abs().max()) <= 1e-6


def test_fd_force_parity_on_physical_dofs(boxes):
    """The wrapped periodic force (row 8's plain version) against central
    finite differences of its energy, displacing physical atoms only; the
    site rows carry zero force after the spread (as JAX's test)."""
    from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn

    _, _, jx, tsys, _ = boxes
    fn = build_periodic_force_fn(tsys)
    x = torch.tensor(jx)
    e0, f = fn(x)
    assert bool(torch.isfinite(e0)) and bool(torch.isfinite(f).all())
    sites = set(tsys.vsite_idx[:, 0].tolist())
    rng = np.random.default_rng(2)
    h = 2e-4
    x64 = np.asarray(jx, np.float64)
    checked = 0
    for _ in range(12):
        a = int(rng.integers(tsys.n_atoms))
        if a in sites:
            continue
        k = int(rng.integers(3))
        xp, xm = x64.copy(), x64.copy()
        xp[a, k] += h
        xm[a, k] -= h
        ep = float(fn(torch.tensor(xp, dtype=torch.float32))[0])
        em = float(fn(torch.tensor(xm, dtype=torch.float32))[0])
        fd = -(ep - em) / (2 * h)
        assert abs(fd - float(f[a, k])) < max(0.8, 0.02 * abs(fd)), (a, k, fd, float(f[a, k]))
        checked += 1
    assert checked >= 4
    assert (f[sorted(sites)] == 0.0).all()


def test_wrapping_is_idempotent_and_keeps_entries(boxes):
    """``wrap_force_fn`` leaves the periodic and cell forces (which handle
    their sites) as they are, and wraps a plain function on every entry."""
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn

    _, _, jx, tsys, _ = boxes
    fn = build_periodic_force_fn(tsys)
    assert wrap_force_fn(fn, tsys) is fn
    cf = build_cell_force_fn(tsys)
    assert wrap_force_fn(cf, tsys) is cf
    # a force function with the cell force's entries, wrapped: each entry
    # hands its inner entry expanded positions and spreads what comes back
    inner = type("Entries", (), {})()
    for name in ("init_state", "apply", "init_state_batched", "apply_batched",
                 "init_state_dynamic", "apply_dynamic", "dynamic", "grid", "phys"):
        setattr(inner, name, getattr(cf, name))
    wrapped = wrap_force_fn(lambda x: cf(x), tsys)
    full = wrap_force_fn(inner, tsys)
    assert full.grid is cf.grid and wrap_force_fn(full, tsys) is full
    x = torch.tensor(_perturbed(jx, seed=9))
    box = torch.tensor(tsys.box) * 1.01
    want = cf(x)
    for got in (wrapped(x), full.apply(x, full.init_state(x))[:2],
                full.apply_batched(x[None], full.init_state_batched(x[None]))[:2]):
        assert torch.equal(got[0].reshape(()), want[0])
        assert torch.equal(got[1].reshape(x.shape), want[1])
    want = cf.dynamic(x, box)
    for got in (full.dynamic(x, box),
                full.apply_dynamic(x, full.init_state_dynamic(x, box), box)[:2]):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_site_count_and_temperature_dof_match_jax(boxes):
    import jax.numpy as jnp
    from pmarlo_tpu.md.integrate import instantaneous_temperature as jax_temperature
    from pmarlo_tpu.md.vsites import n_vsites as jax_n_vsites

    from pmarlo_tpu_torch.md.integrate import instantaneous_temperature

    _, jsys, _, tsys, _ = boxes
    assert n_vsites(tsys) == jax_n_vsites(jsys)
    rng = np.random.default_rng(8)
    v = rng.normal(0.0, 0.5, (tsys.n_atoms, 3)).astype(np.float32)
    v[tsys.vsite_idx[:, 0].long().numpy()] = 0.0
    for n_con, com in ((0, False), (81, False), (81, True)):
        want = float(jax_temperature(jsys, jnp.asarray(v), n_con, remove_com=com))
        got = float(instantaneous_temperature(tsys, torch.tensor(v), n_con, remove_com=com))
        assert abs(got - want) <= 1e-5 * abs(want)


def test_site_velocities_stay_zero(boxes):
    """``initialize_velocities``, ``thermalize`` (with ``remove_com_motion``)
    and ``run_md`` leave the massless site rows at zero velocity; the
    sites follow their parents after every step."""
    from pmarlo_tpu_torch.md.constraints import build_h_constraints
    from pmarlo_tpu_torch.md.integrate import (
        initialize_velocities,
        remove_com_motion,
        run_md,
        thermalize,
    )
    from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn

    _, _, jx, tsys, _ = boxes
    sites = tsys.vsite_idx[:, 0].long()
    gen = torch.Generator().manual_seed(3)
    v = initialize_velocities(tsys, gen, 300.0)
    assert (v[sites] == 0.0).all()
    v2 = remove_com_motion(tsys, v + 1.0)
    assert (v2[sites] == 1.0).all()          # massless rows keep theirs
    p = (tsys.masses[:, None] * v2).sum(0)
    assert float(p.abs().max()) <= 1e-3
    state = thermalize(tsys, torch.tensor(jx), gen, 300.0)
    assert (state.velocities[sites] == 0.0).all()
    state, frames = run_md(tsys, state, n_steps=10, dt=0.002, friction=1.0,
                           temperature_K=300.0, report_interval=5,
                           force_fn=build_periodic_force_fn(tsys),
                           constraints=build_h_constraints(tsys))
    assert (state.velocities[sites] == 0.0).all()
    vs = VirtualSites.from_system(tsys)
    assert float((vs.expand(frames["positions"]) - frames["positions"]).abs().max()) == 0.0


def test_exclusion_band_covers_the_intra_water_pairs(boxes):
    """The sweeps' band (``ExclusionBand.from_system``) masks every pair
    inside a water, 6 (TIP4P-Ew) or 10 (TIP5P), with zero Coulomb and LJ
    scale, as JAX's ``banded_scales`` does."""
    from pmarlo_tpu.md.cells import banded_scales, exclusion_band_width

    from pmarlo_tpu_torch.md.cells import ExclusionBand

    model, jsys, _, tsys, _ = boxes
    band = ExclusionBand.from_system(tsys)
    per_water = 4 if model == "tip4pew" else 5
    assert band.width == exclusion_band_width(jsys) >= per_water - 1
    se, sl = band.band_se, band.band_sl
    for w in range(27):
        base = per_water * w
        for a in range(per_water):
            for k in range(1, per_water - a):
                assert se[base + a, k - 1] == 0.0 and sl[base + a, k - 1] == 0.0
    want = banded_scales(jsys, band.width)
    for got, ref in zip((band.band_se, band.band_sl, band.far_idx), want[:3]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
