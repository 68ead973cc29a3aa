"""The water-model checks of the port (``features/rdf.py`` and
``features/msd.py``) against the JAX package's, the mirror of
``test_rdf.py`` and ``test_msd.py``: g(r), the coordination number, the
unwrap, the MSD and D at 1e-5, on orthorhombic and triclinic cells."""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.features import (
    coordination_number,
    diffusion_coefficient,
    mean_squared_displacement,
    radial_distribution,
    unwrap_trajectory,
)

SHEAR = (0.3, -0.2, 0.25)


def _cloud(seed, frames=6, n=80, side=2.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, side, (frames, n, 3)).astype(np.float32)


@pytest.mark.parametrize("tilt", [None, SHEAR], ids=["orthorhombic", "triclinic"])
@pytest.mark.parametrize("select", ["self", "cross", "overlap"])
def test_rdf_matches_jax(tilt, select):
    from pmarlo_tpu.features.rdf import radial_distribution as jax_rdf

    x = _cloud(1)
    box = (2.0, 2.0, 2.0)
    ia = np.arange(40) if select != "self" else np.arange(80)
    ib = {"self": None, "cross": np.arange(40, 80), "overlap": np.arange(20, 70)}[select]
    kw = dict(r_max=0.75, n_bins=30, tilt=tilt)
    r, g = radial_distribution(torch.tensor(x), box, ia, ib, **kw)
    jr, jg = jax_rdf(x, box, ia, ib, **kw)
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5)
    # numpy input and one frame without the frame axis
    r1, g1 = radial_distribution(x[0], box, ia, ib, **kw)
    jr1, jg1 = jax_rdf(x[0], box, ia, ib, **kw)
    np.testing.assert_allclose(g1, jg1, rtol=1e-5, atol=1e-5)


def test_rdf_analytic_cases_match_jax():
    from pmarlo_tpu.features.rdf import coordination_number as jax_coordination
    from pmarlo_tpu.features.rdf import radial_distribution as jax_rdf

    x = _cloud(0, frames=40, n=200)
    r, g = radial_distribution(x, (2.0, 2.0, 2.0), np.arange(200), r_max=0.95, n_bins=19)
    assert np.all(np.abs(g[4:] - 1.0) < 0.15)
    n = coordination_number(r, g, rho=199 / 8.0, r_cut=0.9)
    jr, jg = jax_rdf(x, (2.0, 2.0, 2.0), np.arange(200), r_max=0.95, n_bins=19)
    assert abs(n - jax_coordination(jr, jg, rho=199 / 8.0, r_cut=0.9)) <= 1e-5 * n
    two = np.zeros((1, 2, 3), np.float32)
    two[0, 1, 0] = 0.5
    r, g = radial_distribution(two, (3.0, 3.0, 3.0), [0], [1], r_max=1.0, n_bins=50)
    assert abs(r[int(np.argmax(g))] - 0.5) < 0.02 and np.count_nonzero(g) == 1
    with pytest.raises(ValueError, match="half the smallest perpendicular"):
        radial_distribution(np.zeros((1, 4, 3)), (1.0, 1.0, 1.0), np.arange(4), r_max=0.6)


def _walk(seed, frames=60, n=16, box=1.5):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0.0, 0.05, (frames, n, 3)), axis=0) + 0.7
    return x.astype(np.float32), np.mod(x, box).astype(np.float32)


@pytest.mark.parametrize("tilt", [None, SHEAR], ids=["orthorhombic", "triclinic"])
def test_unwrap_matches_jax(tilt):
    from pmarlo_tpu.features.msd import unwrap_trajectory as jax_unwrap

    box = (1.5, 1.5, 1.5)
    true, wrapped = _walk(2)
    if tilt is not None:
        from pmarlo_tpu_torch.md.box import box_matrix

        H = box_matrix(box, tilt)
        frac = np.mod(true @ np.linalg.inv(H), 1.0)
        wrapped = (frac @ H).astype(np.float32)
    got = unwrap_trajectory(torch.tensor(wrapped), box, tilt=tilt).numpy()
    want = np.asarray(jax_unwrap(wrapped, box, tilt=tilt))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got - got[0], true - true[0], atol=1e-4)


@pytest.mark.parametrize("tilt", [None, SHEAR], ids=["orthorhombic", "triclinic"])
@pytest.mark.parametrize("com", [False, True])
def test_msd_and_diffusion_match_jax(tilt, com):
    from pmarlo_tpu.features.msd import diffusion_coefficient as jax_diffusion
    from pmarlo_tpu.features.msd import mean_squared_displacement as jax_msd

    box = (1.5, 1.5, 1.5)
    _, wrapped = _walk(3)
    masses = np.linspace(1.0, 16.0, wrapped.shape[1])
    kw = dict(max_lag=30, remove_com=com, masses=masses if com else None, tilt=tilt)
    idx = np.arange(0, 16, 2)
    lags, msd = mean_squared_displacement(torch.tensor(wrapped), box, idx, **kw)
    jlags, jmsd = jax_msd(wrapped, box, idx, **kw)
    np.testing.assert_array_equal(lags, jlags)
    np.testing.assert_allclose(msd, jmsd, rtol=1e-5, atol=1e-7)
    d = diffusion_coefficient(lags, msd, dt_per_lag_ps=0.2)
    assert abs(d - jax_diffusion(jlags, jmsd, dt_per_lag_ps=0.2)) <= 1e-5 * abs(d)


def test_msd_analytic_cases():
    t = np.arange(30, dtype=np.float32)
    v = np.array([0.2, -0.1, 0.05], np.float32)
    x = (t[:, None, None] * v[None, None, :]).repeat(4, axis=1)
    lags, msd = mean_squared_displacement(x)
    np.testing.assert_allclose(msd, np.sum(v**2) * lags.astype(float) ** 2, rtol=1e-4)
    lags, msd = mean_squared_displacement(x[:1])
    assert list(lags) == [0] and list(msd) == [0.0]
