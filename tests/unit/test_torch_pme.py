"""Smooth PME in the port (``pmarlo_tpu_torch/md/pme.py``, ``md/eft.py``)
and on the cell path (``build_cell_force_fn(electrostatics="pme")``),
held against the JAX package on the same seeded numpy inputs.

- df32 transforms: exact against float64, and the same bits as JAX's.
- The reciprocal energy, orthorhombic and triclinic, float32 and df32
  spreading, a static box and a box tensor: energy to 1e-5 relative,
  autograd forces to 1e-4 of the largest.
- The NaCl Madelung constant to 4 decimals and its alpha independence (the
  mirrors of ``tests/unit/test_pme.py``); grid rounding; the splines'
  partition of unity; spreading by ``index_add_`` against JAX's one-hot
  matmuls.
- The cell path on the 2,187-atom water box (2.89 nm, 3 cells a side at
  0.9 nm), its plain sweep, against JAX's ``ewald_energy_dense`` plus the
  force field's exclusions and LJ: energy to 1e-5 relative, forces to 1e-4
  of the largest.
"""

import math

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.md import eft, pme

jax = pytest.importorskip("jax")
jnp = jax.numpy

MADELUNG_NACL = 1.747564594


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / np.abs(np.asarray(b, np.float64)).max())


# --- df32 --------------------------------------------------------------------------


def test_two_sum_and_two_prod_are_exact_and_match_jax():
    """hi + lo equals the float64 sum and product exactly (the float32
    inputs' product fits a float64), and both packages give the same
    bits."""
    from pmarlo_tpu.md import eft as jeft

    rng = np.random.default_rng(1)
    a = rng.uniform(-1e4, 1e4, 2000).astype(np.float32)
    b = rng.uniform(-1e-4, 1e4, 2000).astype(np.float32)
    for fn, jfn, op in ((eft.two_sum, jeft.two_sum, np.add),
                        (eft.two_prod, jeft.two_prod, np.multiply)):
        hi, lo = fn(torch.from_numpy(a), torch.from_numpy(b))
        exact = op(a.astype(np.float64), b.astype(np.float64))
        np.testing.assert_array_equal(hi.numpy().astype(np.float64)
                                      + lo.numpy().astype(np.float64), exact)
        jhi, jlo = jfn(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def test_df_inverse_and_product_against_float64():
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 9.0, 500).astype(np.float32)
    hi, lo = eft.df_inv(torch.from_numpy(a))
    got = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    np.testing.assert_allclose(got, 1.0 / a.astype(np.float64), rtol=1e-12)
    x = eft.df_const(math.pi)
    y = eft.df(torch.from_numpy(a))
    p = eft.df_mul((torch.full_like(y[0], x[0]), torch.full_like(y[0], x[1])), y)
    got = p[0].numpy().astype(np.float64) + p[1].numpy().astype(np.float64)
    np.testing.assert_allclose(got, math.pi * a.astype(np.float64), rtol=1e-13)


# --- the reciprocal sum ------------------------------------------------------------


def _charges(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0.0, 0.5, n)
    return (q - q.mean()).astype(np.float32)


CASES = [
    (4, False, None), (6, False, None), (6, True, None),
    (6, False, (0.3, 0.2, -0.4)), (6, True, (0.3, 0.2, -0.4)), (4, True, (0.3, 0.2, -0.4)),
]


@pytest.mark.parametrize("order,precise,tilt", CASES)
def test_reciprocal_energy_matches_jax(order, precise, tilt):
    from pmarlo_tpu.md import pme as jpme

    rng = np.random.default_rng(order + 10 * precise)
    box = (1.9, 2.1, 2.3)
    x = (rng.uniform(0.0, 1.0, (80, 3)) * np.array(box) - 0.3).astype(np.float32)
    q = _charges(80, 3)
    alpha = pme.ewald_alpha(0.9)
    shape = pme.pme_grid_shape(box, pme.pme_spacing(6, alpha))
    je, jg = jax.jit(jax.value_and_grad(lambda p: jpme.reciprocal_energy(
        p, jnp.asarray(q), box, alpha, shape, order, tilt=tilt, precise=precise)))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    te = pme.reciprocal_energy(xt, torch.tensor(q), box, alpha, shape, order, tilt=tilt,
                               precise=precise)
    (tg,) = torch.autograd.grad(te, xt)
    te = te.detach()
    assert abs(float(te) - float(je)) <= 1e-5 * abs(float(je))
    assert _rel(tg, jg) <= 1e-4


@pytest.mark.parametrize("ratios", [None, (0.1, 0.05, -0.2)], ids=["orthorhombic", "tilted"])
@pytest.mark.parametrize("precise", [False, True], ids=["float32", "df32"])
def test_reciprocal_energy_of_a_box_tensor_matches_jax(ratios, precise):
    """The NPT form: the box a (3,) tensor (a traced array in JAX), the
    tilt as static ratios; and at the same box it equals the static form."""
    from pmarlo_tpu.md import pme as jpme

    rng = np.random.default_rng(5)
    box = (2.2, 2.0, 2.4)
    x = (rng.uniform(0.0, 1.0, (60, 3)) * np.array(box)).astype(np.float32)
    q = _charges(60, 6)
    alpha = pme.ewald_alpha(0.9)
    shape = pme.pme_grid_shape(box, pme.pme_spacing(6, alpha))
    je, jg = jax.jit(jax.value_and_grad(lambda p, b: jpme.reciprocal_energy(
        p, jnp.asarray(q), b, alpha, shape, 6, tilt_ratios=ratios, precise=precise)))(
        jnp.asarray(x), jnp.asarray(box, jnp.float32))
    xt = torch.tensor(x, requires_grad=True)
    te = pme.reciprocal_energy(xt, torch.tensor(q), torch.tensor(box, dtype=torch.float32),
                               alpha, shape, 6, tilt_ratios=ratios, precise=precise)
    (tg,) = torch.autograd.grad(te, xt)
    te = te.detach()
    assert abs(float(te) - float(je)) <= 1e-5 * abs(float(je))
    assert _rel(tg, jg) <= 1e-4
    if ratios is None:
        es = pme.reciprocal_energy(torch.tensor(x), torch.tensor(q), box, alpha, shape, 6,
                                   precise=precise)
        assert abs(float(es) - float(te)) <= 1e-5 * abs(float(es))


def test_spread_charges_matches_jax_one_hot_matmuls():
    """``index_add_`` spreading against JAX's dense one-hot weight matrices
    (positions outside the cell too), and the total equals the charge."""
    from pmarlo_tpu.md import pme as jpme

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 4, (50, 3)).astype(np.float32)
    q = rng.normal(size=50).astype(np.float32)
    for order in (4, 6):
        grid = pme.spread_charges(torch.tensor(x), torch.tensor(q), (3.0, 3.0, 3.0),
                                  (24, 24, 16), order)
        jgrid = jpme.spread_charges(jnp.asarray(x), jnp.asarray(q), (3.0, 3.0, 3.0),
                                    (24, 24, 16), order)
        np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=2e-6)
        assert abs(float(grid.sum()) - float(q.sum())) <= 1e-4


def test_spline_partition_of_unity_and_grid_rounding():
    t = torch.tensor(np.random.default_rng(1).uniform(0, 1, 64), dtype=torch.float32)
    for order in (4, 5, 6):
        s = pme._bspline_weights(t, order).sum(-1)
        np.testing.assert_allclose(s.numpy(), 1.0, atol=5e-6)
        hi, lo = pme._bspline_weights_df(t, torch.zeros_like(t), order)
        np.testing.assert_allclose((hi.double() + lo.double()).sum(-1).numpy(), 1.0,
                                   atol=1e-12)
    np.testing.assert_allclose(pme._mn_integer(6), np.array([1, 26, 66, 26, 1]) / 120.0,
                               atol=1e-12)
    s = pme.pme_grid_shape((3.0018, 2.8549, 2.6764))
    assert all(k % 8 == 0 and k >= 16 for k in s)
    assert pme.pme_grid_shape((0.5, 0.5, 0.5)) == (16, 16, 16)


def _rocksalt(n_side=6, d=0.30):
    idx = np.arange(n_side)
    ii, jj, kk = np.meshgrid(idx, idx, idx, indexing="ij")
    x = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3) * d + d / 2
    q = ((-1.0) ** (ii + jj + kk)).reshape(-1)
    L = n_side * d
    return (torch.tensor(x, dtype=torch.float32), torch.tensor(q, dtype=torch.float32),
            (L, L, L))


def test_madelung_constant_and_alpha_independence():
    """The full PME energy of the NaCl lattice gives the Madelung constant
    to 4 decimals, and moving the split between real and reciprocal
    space leaves it (mirrors of ``test_pme.py``)."""
    from pmarlo_tpu_torch.constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 as KE

    x, q, box = _rocksalt(6, d=0.30)
    # the default tolerance (5e-4) leaves M 7e-4 low, the real-space
    # truncation; four decimals take a sharper split
    alpha = pme.ewald_alpha(0.85, 1e-5)
    e = float(pme.ewald_energy_dense(x, q, box, cutoff=0.85, alpha=alpha))
    M = -e * 2.0 * 0.30 / (x.shape[0] * KE)
    assert abs(M - MADELUNG_NACL) < 5e-5, M
    e2 = float(pme.ewald_energy_dense(x, q, box, cutoff=0.85, alpha=alpha * 1.25))
    assert abs(e - e2) < 2e-4 * abs(e)
    e_default = float(pme.ewald_energy_dense(x, q, box, cutoff=0.85))
    assert abs(e_default - e) < 5e-3 * abs(e)


# --- the cell path -----------------------------------------------------------------


def _jax_water_system(n_side, cutoff):
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu_torch.data.water import water_box_structure
    from test_torch_cell_force import _jax_structure

    s, box = water_box_structure(n_side)
    return jax_build_system(_jax_structure(s), box=box, cutoff=cutoff, hydrogen_mass=None)


def jax_pme_oracle(jsys, x, shape, order):
    """``(energy, forces)`` of the force field with smooth PME by JAX's
    dense functions: the terms of ``ewald_energy_dense`` (the dense real
    space, the mesh, self and background; ``ewald_energy_dense`` itself
    takes spline order 4, the cell path 6) with the excluded and 1-4 pairs
    left out of the real space, those pairs' scaled bare Coulomb less the
    erf part the mesh counted (float64 on the host, where the terms are
    large and cancel), and the LJ and bonded terms of the dense periodic
    energy with the charges zeroed. JAX evaluates in float64 here: in
    float32 the cancelling terms of a small water box leave the total 1e-5
    off a float64 evaluation, the bound held."""
    import dataclasses

    from scipy.special import erf

    from pmarlo_tpu.constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 as KE
    from pmarlo_tpu.md import pme as jpme
    from pmarlo_tpu.md.forces import potential_energy

    box = tuple(float(b) for b in jsys.box)
    rc = float(jsys.cutoff)
    q = np.asarray(jsys.charges, np.float32)
    alpha = jpme.ewald_alpha(rc)
    se = np.asarray(jsys.scale_elec, np.float64)
    excl = jnp.asarray((se < 1.0).astype(np.float32))

    def ewald(p):
        qj = jnp.asarray(q, p.dtype)
        return (jpme.real_space_energy_dense(p, qj, box, rc, alpha, exclude_mask=excl)
                + jpme.reciprocal_energy(p, qj, box, alpha, shape, order)
                + jpme.self_energy(qj, alpha) + jpme.background_energy(qj, box, alpha))

    sys_lj = dataclasses.replace(jsys, charges=jnp.zeros_like(jnp.asarray(jsys.charges)))
    with jax.enable_x64(True):
        xj = jnp.asarray(x, jnp.float64)
        excl = jnp.asarray(excl, jnp.float64)
        e_el, g_el = jax.value_and_grad(ewald)(xj)
        e_lj, g_lj = jax.value_and_grad(lambda p: potential_energy(sys_lj, p))(xj)
        e_el, g_el, e_lj, g_lj = (np.asarray(a, np.float64) for a in (e_el, g_el, e_lj, g_lj))
    i, j = np.triu_indices(se.shape[0], k=1)
    keep = se[i, j] < 1.0
    i, j, s = i[keep], j[keep], se[i[keep], j[keep]]
    d = x[i].astype(np.float64) - x[j].astype(np.float64)
    d -= np.asarray(box) * np.round(d / np.asarray(box))
    r = np.sqrt((d * d).sum(-1))
    c = KE * q[i].astype(np.float64) * q[j]
    e_corr = float((c * (s - erf(alpha * r)) / r).sum())
    dEdr = c * (-(s - erf(alpha * r)) / r**2
                - 2.0 * alpha / np.sqrt(np.pi) * np.exp(-(alpha * r) ** 2) / r)
    f_pair = (-dEdr / r)[:, None] * d          # force on i
    f_corr = np.zeros_like(x, dtype=np.float64)
    np.add.at(f_corr, i, f_pair)
    np.add.at(f_corr, j, -f_pair)
    energy = float(e_el) + float(e_lj) + e_corr
    forces = -np.asarray(g_el, np.float64) - np.asarray(g_lj, np.float64) + f_corr
    return energy, forces


@pytest.fixture(scope="module")
def water_2187():
    from pmarlo_tpu_torch.md.system import system_from_numpy

    jsys, jx = _jax_water_system(9, 0.9)
    x = (np.asarray(jx) + np.random.default_rng(31).normal(0.0, 0.01, np.shape(jx))
         ).astype(np.float32)
    return jsys, system_from_numpy(jsys.to_dict(), device="cpu"), x


def test_cell_path_pme_matches_jax_dense_ewald(water_2187):
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn

    jsys, system, x = water_2187
    assert system.n_atoms == 2187
    fn = build_cell_force_fn(system, electrostatics="pme", ewald_shift=False)
    assert (fn.grid.nx, fn.grid.ny, fn.grid.nz) == (3, 3, 3)
    assert fn.electrostatics == "pme" and fn.pme_order == 6 and fn.phys.shift_c == 0.0
    e, f = fn(torch.tensor(x))
    e_ref, f_ref = jax_pme_oracle(jsys, x, fn.pme_mesh_shape, fn.pme_order)
    assert abs(float(e) - e_ref) <= 1e-5 * abs(e_ref), (float(e), e_ref)
    assert _rel(f, f_ref) <= 1e-4


def test_cell_path_pme_matches_jax_cell_pme_options(water_2187):
    """The options of JAX's PME wiring: the mesh JAX chooses (also refined),
    the shifted real-space term's constant, the df32 spreading; energies
    and forces against JAX's own ``reciprocal_energy`` on that mesh."""
    from pmarlo_tpu.md import pme as jpme
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn

    jsys, system, x = water_2187
    rc = 0.9
    alpha = jpme.ewald_alpha(rc, 5e-4)
    for refine, precise in ((1.0, True), (1.5, False)):
        fn = build_cell_force_fn(system, electrostatics="pme", pme_mesh_refine=refine,
                                 pme_precise=precise)
        want = jpme.pme_grid_shape(tuple(jsys.box), jpme.pme_spacing(6, alpha) / refine)
        assert fn.pme_mesh_shape == want and fn.pme_precise == precise
        assert fn.phys.shift_c == pytest.approx(math.erfc(alpha * rc) / rc, rel=1e-5)
        q = torch.as_tensor(np.asarray(jsys.charges, np.float32))
        em, fm = fn._mesh_terms(torch.tensor(x)[None], None)
        je, jg = jax.value_and_grad(lambda p: jpme.reciprocal_energy(
            p, jnp.asarray(q.numpy()), tuple(jsys.box), alpha, want, 6, precise=precise))(
            jnp.asarray(x))
        e_static = float(jpme.self_energy(jnp.asarray(q.numpy()), alpha)) + float(
            jpme.background_energy(jnp.asarray(q.numpy()), tuple(jsys.box), alpha))
        assert abs(float(em[0]) - float(je) - e_static) <= 1e-5 * abs(float(je) + e_static)
        assert _rel(fm[0], -np.asarray(jg)) <= 1e-4
    with pytest.raises(ValueError, match="pme_mesh_refine"):
        build_cell_force_fn(system, electrostatics="pme", pme_mesh_refine=0.5)


@pytest.mark.parametrize("nonbonded,precise", [("pme", False), ("pme", True), ("cells", False)])
def test_explicit_setup_routes_to_smooth_pme(nonbonded, precise):
    """``build_explicit_setup(nonbonded="pme", pme_precise=)`` builds the
    cell path with smooth PME for MD and minimization; ``pme_precise``
    without the PME engine raises, as in JAX."""
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.md.setup import build_explicit_setup

    s, _ = water_box_structure(4)
    setup = build_explicit_setup(s, cutoff=0.4, nonbonded=nonbonded, pme_precise=precise,
                                 device="cpu")
    want = "pme" if nonbonded == "pme" else "rf"
    assert setup.md_force_fn.electrostatics == want
    assert setup.minimize_force_fn.electrostatics == want
    if nonbonded == "pme":
        assert setup.nonbonded == "pme" and setup.md_force_fn.pme_precise == precise
        e, f = setup.md_force_fn(setup.positions)
        assert bool(torch.isfinite(e)) and bool(torch.isfinite(f).all())
    else:
        with pytest.raises(ValueError, match="pme_precise"):
            build_explicit_setup(s, cutoff=0.4, nonbonded=nonbonded, pme_precise=True,
                                 device="cpu")
