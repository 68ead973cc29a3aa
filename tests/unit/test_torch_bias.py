"""``pmarlo_tpu_torch.bias`` and the biased plain MD paths against
``pmarlo_tpu.bias``: harmonic expansion, the metadynamics ledger
(energy, deposits incl. a full ledger, reweighting; 1e-5), the composed
force functions, and the port's mirror of
``tests/integration/test_biased_remd.py`` at a size that is not slow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmarlo_tpu.bias import HarmonicExpansionBias as JHarmonic
from pmarlo_tpu.bias import MetadynamicsBias as JMetaD
from pmarlo_tpu.bias.harmonic import make_phi_psi_feature_fn as j_phi_psi_fn
from pmarlo_tpu_torch.bias import (
    HarmonicExpansionBias,
    MetadynamicsBias,
    MetaDState,
    make_cv_bias_fn,
)
from pmarlo_tpu_torch.bias.harmonic import make_feature_cv_fn, make_phi_psi_feature_fn
from pmarlo_tpu_torch.bias.metadynamics import metad_state_from_numpy
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.features import TopologyInfo, featurize_trajectory
from pmarlo_tpu_torch.md import analytic
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.integrate import (
    bias_energy_and_forces,
    make_force_fn,
    run_md,
    thermalize,
)
from pmarlo_tpu_torch.md.minimize import minimize_energy
from pmarlo_tpu_torch.md.setup import compose_bias
from pmarlo_tpu_torch.md.topology import build_topology
from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig, deeptica_from_numpy, train_deeptica
from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange, run_replica_exchange


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def alanine():
    structure = alanine_dipeptide_structure()
    topo = build_topology(structure)
    system, positions = build_system(structure, gb_model="gbn2", device="cpu")
    return system, positions, TopologyInfo.from_topology(topo)


def _model(n_features, seed=0, n_out=2):
    rng = np.random.default_rng(seed)
    sizes = [n_features, 8, n_out]
    params = [{"w": rng.normal(0.0, 0.5, (a, b)).astype(np.float32),
               "b": rng.normal(0.0, 0.1, b).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    return deeptica_from_numpy(
        DeepTICAConfig(hidden=(8,), n_out=n_out), params,
        rng.normal(0.0, 0.2, n_features).astype(np.float32),
        rng.uniform(0.5, 1.5, n_features).astype(np.float32),
        {"mean": np.zeros(n_out, np.float32),
         "transform": rng.normal(0.0, 1.0, (n_out, n_out)).astype(np.float32)})


# --- harmonic ----------------------------------------------------------------------------

def test_harmonic_expansion_matches_jax():
    cv = np.random.default_rng(0).normal(size=(5, 2)).astype(np.float32)
    got = HarmonicExpansionBias(strength=1.7)(torch.as_tensor(cv)).numpy()
    want = np.asarray([float(JHarmonic(strength=1.7)(jnp.asarray(c))) for c in cv])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("cos_sin", [True, False], ids=["cos_sin", "angles"])
def test_phi_psi_feature_fn_matches_jax(alanine, cos_sin):
    system, positions, info = alanine
    rng = np.random.default_rng(1)
    x = positions.numpy()[None] + rng.normal(0.0, 0.02, (3,) + tuple(positions.shape))
    x = x.astype(np.float32)
    fn = make_phi_psi_feature_fn(info.atom_names, info.residue_ids, cos_sin=cos_sin)
    jfn = j_phi_psi_fn(info.atom_names, info.residue_ids, cos_sin=cos_sin)
    got = fn(torch.as_tensor(x)).numpy()
    want = np.stack([np.asarray(jfn(jnp.asarray(xi))) for xi in x])
    assert got.shape == want.shape == (3, 4 if cos_sin else 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_composed_cv_bias_energy_and_forces_match_jax_grad(alanine):
    """positions -> phi/psi -> DeepTICA -> k sum cv^2: the energy and the
    autograd force against jax.grad of the JAX composition (1e-4 of the
    largest force)."""
    from pmarlo_tpu.bias import make_cv_bias_fn as j_make_cv_bias_fn
    from pmarlo_tpu.bias.harmonic import make_feature_cv_fn as j_make_feature_cv_fn
    from pmarlo_tpu.ml.deeptica import DeepTICAConfig as JConfig
    from pmarlo_tpu.ml.deeptica import DeepTICAModel as JModel

    system, positions, info = alanine
    model = _model(4)
    jmodel = JModel(
        config=JConfig(hidden=(8,), n_out=2),
        params=[{k: jnp.asarray(v.numpy()) for k, v in layer.items()} for layer in model.params],
        scaler_mean=model.scaler_mean, scaler_scale=model.scaler_scale,
        whitening=model.whitening)
    bias_fn = make_cv_bias_fn(
        make_feature_cv_fn(make_phi_psi_feature_fn(info.atom_names, info.residue_ids),
                           model.as_function()),
        HarmonicExpansionBias(strength=2.0))
    jbias_fn = j_make_cv_bias_fn(
        j_make_feature_cv_fn(j_phi_psi_fn(info.atom_names, info.residue_ids),
                             jmodel.as_function()),
        JHarmonic(strength=2.0))
    rng = np.random.default_rng(2)
    x = (positions.numpy()[None] + rng.normal(0.0, 0.02, (3,) + tuple(positions.shape)))
    x = x.astype(np.float32)
    e, f = bias_energy_and_forces(bias_fn, torch.as_tensor(x))
    je = np.asarray([float(jbias_fn(jnp.asarray(xi))) for xi in x])
    jf = np.stack([-np.asarray(jax.grad(jbias_fn)(jnp.asarray(xi))) for xi in x])
    np.testing.assert_allclose(e.numpy(), je, rtol=1e-4, atol=1e-5)
    assert np.abs(f.numpy() - jf).max() <= 1e-4 * np.abs(jf).max()
    assert float(f.abs().max()) > 0.0


# --- metadynamics ---------------------------------------------------------------------------

def _deposit_both(kw, cvs):
    tm, jm = MetadynamicsBias(**kw), JMetaD(**kw)
    ts, js = tm.init_state(2), jm.init_state(2)
    for cv in cvs:
        ts = tm.deposit(ts, torch.as_tensor(cv))
        js = jm.deposit(js, jnp.asarray(cv))
    return tm, jm, ts, js


@pytest.mark.parametrize("bias_factor", [None, 6.0], ids=["standard", "well_tempered"])
def test_metadynamics_deposit_energy_reweighting_match_jax(bias_factor):
    rng = np.random.default_rng(3)
    kw = dict(sigma=(0.3, 0.5), height=1.5, max_hills=16, bias_factor=bias_factor)
    cvs = rng.normal(0.0, 0.4, (10, 2)).astype(np.float32)
    tm, jm, ts, js = _deposit_both(kw, cvs)
    assert int(ts.n_hills) == int(js.n_hills) == 10
    np.testing.assert_allclose(ts.centers.numpy(), np.asarray(js.centers), atol=1e-6)
    np.testing.assert_allclose(ts.heights.numpy(), np.asarray(js.heights), rtol=1e-5)
    if bias_factor is not None:
        h = ts.heights[:10]
        assert float(h[0]) == pytest.approx(1.5) and bool((h[1:] < 1.5).all())
    probe = rng.normal(0.0, 0.5, (7, 2)).astype(np.float32)
    got = tm.energy(ts, torch.as_tensor(probe)).numpy()
    want = np.asarray([float(jm.energy(js, jnp.asarray(p))) for p in probe])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.reweighting_factors(ts, probe),
                               np.asarray(jm.reweighting_factors(js, probe)), rtol=1e-5)
    np.testing.assert_allclose(
        tm.reweighting_factors(ts, probe, temperature_K=450.0),
        np.asarray(jm.reweighting_factors(js, probe, temperature_K=450.0)), rtol=1e-5)


def test_full_ledger_drops_further_deposits_as_jax():
    rng = np.random.default_rng(4)
    kw = dict(sigma=(0.3, 0.3), height=1.0, max_hills=4, bias_factor=5.0)
    cvs = rng.normal(0.0, 0.4, (7, 2)).astype(np.float32)
    _, _, ts, js = _deposit_both(kw, cvs)
    assert int(ts.n_hills) == int(js.n_hills) == 4
    np.testing.assert_allclose(ts.centers.numpy(), np.asarray(js.centers), atol=1e-6)
    np.testing.assert_allclose(ts.centers.numpy(), cvs[:4], atol=1e-6)
    np.testing.assert_allclose(ts.heights.numpy(), np.asarray(js.heights), rtol=1e-5)


def test_metadynamics_validation_and_center_replacement():
    mtd = MetadynamicsBias(sigma=(0.3, 0.3), max_hills=4, bias_factor=1.0)
    with pytest.raises(ValueError, match="bias_factor"):
        mtd.deposit(mtd.init_state(2), torch.zeros(2))
    mtd = MetadynamicsBias(sigma=(0.3, 0.3), max_hills=4)
    state = mtd.deposit(mtd.init_state(2), torch.tensor([0.2, -0.1]))
    moved = mtd.reproject(state, lambda c: c + 1.0)
    torch.testing.assert_close(moved.centers, state.centers + 1.0)
    assert int(moved.n_hills) == 1 and torch.equal(moved.heights, state.heights)
    with pytest.raises(ValueError, match="all ledger slots"):
        mtd.set_centers(state, torch.zeros((2, 2)))
    from_np = metad_state_from_numpy(state.centers.numpy(), state.heights.numpy(), 1)
    assert isinstance(from_np, MetaDState) and from_np.n_hills.dtype == torch.int32
    torch.testing.assert_close(mtd.energy(from_np, torch.tensor([0.2, -0.1])),
                               torch.tensor(1.0))


def test_metadynamics_energy_batches_over_leading_dimensions():
    mtd = MetadynamicsBias(sigma=(0.3, 0.3), max_hills=8)
    state = mtd.init_state(2)
    for c in ([0.0, 0.0], [0.5, 0.5]):
        state = mtd.deposit(state, torch.tensor(c))
    cv = torch.as_tensor(np.random.default_rng(5).normal(size=(3, 4, 2)).astype(np.float32))
    e = mtd.energy(state, cv)
    assert e.shape == (3, 4)
    torch.testing.assert_close(e[1, 2], mtd.energy(state, cv[1, 2]))


# --- composed force functions --------------------------------------------------------------

def test_make_force_fn_adds_the_bias_to_energy_and_forces(alanine):
    system, positions, info = alanine
    bias_fn = lambda x: 3.0 * (x[..., 0, :] - x[..., 5, :]).pow(2).sum(-1)  # noqa: E731
    x = positions[None].repeat(2, 1, 1) + 0.01
    e0, f0 = make_force_fn(system)(x)
    e1, f1 = make_force_fn(system, bias_fn)(x)
    ea, fa = analytic.energy_and_forces(analytic.make_dense_params(system), x)
    torch.testing.assert_close(e0, ea)
    torch.testing.assert_close(f0, fa)
    be, bf = bias_energy_and_forces(bias_fn, x)
    torch.testing.assert_close(e1, e0 + be)
    torch.testing.assert_close(f1, f0 + bf)
    d = x[:, 0] - x[:, 5]
    torch.testing.assert_close(bf[:, 0], -6.0 * d)
    torch.testing.assert_close(bf[:, 5], 6.0 * d)
    e2, f2 = compose_bias(make_force_fn(system), bias_fn)(x)
    torch.testing.assert_close(e2, e1)
    torch.testing.assert_close(f2, f1)


def test_biased_force_fn_matches_jax(alanine):
    """The port's biased force function against JAX's
    ``make_force_fn(system, bias_fn)`` on the same positions."""
    from pmarlo_tpu.data import alanine_dipeptide_structure as j_alanine
    from pmarlo_tpu.md.forcefield import build_system as j_build_system
    from pmarlo_tpu.md.integrate import make_force_fn as j_make_force_fn

    system, positions, info = alanine
    jsystem, _ = j_build_system(j_alanine(), gb_model="gbn2")
    tfn = make_phi_psi_feature_fn(info.atom_names, info.residue_ids)
    jfn = j_phi_psi_fn(info.atom_names, info.residue_ids)
    tbias = lambda x: 4.0 * tfn(x).pow(2).sum(-1)            # noqa: E731
    jbias = lambda x: 4.0 * jnp.sum(jfn(x) ** 2)             # noqa: E731
    x = positions.numpy() + np.random.default_rng(6).normal(0, 0.01, positions.shape)
    x = x.astype(np.float32)
    e, f = make_force_fn(system, tbias)(torch.as_tensor(x))
    je, jf = j_make_force_fn(jsystem, jbias)(jnp.asarray(x))
    assert abs(float(e) - float(je)) <= 1e-4 * abs(float(je))
    assert np.abs(f.numpy() - np.asarray(jf)).max() <= 1e-4 * np.abs(np.asarray(jf)).max()


def test_minimize_energy_feels_the_bias(alanine):
    system, positions, _ = alanine
    pull = lambda x: 500.0 * ((x[..., 0, :] - x[..., 21, :]).pow(2).sum(-1) - 4.0).pow(2)  # noqa: E731
    x_free, _ = minimize_energy(system, positions, max_iterations=60)
    x_pull, _ = minimize_energy(system, positions, max_iterations=60, bias_fn=pull)
    d_free = float((x_free[0] - x_free[21]).norm())
    d_pull = float((x_pull[0] - x_pull[21]).norm())
    assert d_pull > d_free + 0.05


def test_run_md_takes_a_bias_and_refuses_bias_with_override(alanine):
    system, positions, _ = alanine
    gen = torch.Generator().manual_seed(0)
    state = thermalize(system, positions, gen, 300.0)
    bias_fn = lambda x: 10.0 * (x[..., 0, :] - x[..., 5, :]).pow(2).sum(-1)  # noqa: E731
    s1, out1 = run_md(system, state, n_steps=20, dt=0.002, friction=1.0,
                      temperature_K=300.0, report_interval=10, bias_fn=bias_fn)
    s0, out0 = run_md(system, state, n_steps=20, dt=0.002, friction=1.0,
                      temperature_K=300.0, report_interval=10)
    assert bool(torch.isfinite(s1.positions).all())
    assert not torch.equal(s1.positions, s0.positions)
    # the reported potential includes the bias
    e_phys, _ = make_force_fn(system)(s1.positions)
    assert float(out1["potential_energy"][-1]) == pytest.approx(
        float(e_phys + bias_fn(s1.positions)), rel=1e-5)
    with pytest.raises(ValueError, match="not both"):
        run_md(system, state, n_steps=10, dt=0.002, friction=1.0, temperature_K=300.0,
               report_interval=10, bias_fn=bias_fn, force_fn=make_force_fn(system))


# --- the mirror of tests/integration/test_biased_remd.py ---------------------------------------

def test_deeptica_biased_remd_end_to_end(alanine):
    """Unbiased REMD -> cos/sin phi/psi -> DeepTICA -> bias_fn -> biased
    REMD on the plain path, at 2 replicas and a few hundred steps."""
    system, positions, info = alanine
    cfg = RemdConfig(n_replicas=2, t_min=300.0, t_max=400.0, exchange_frequency=20,
                     report_interval=10, seed=0)
    remd = ReplicaExchange(system, positions, cfg, device="cpu")
    seed_run = remd.run(400)
    feats = [featurize_trajectory(seed_run.demuxed_trajectory(r), "phi_psi", info,
                                  cos_sin_expand=True)[0] for r in range(2)]
    assert feats[0].shape == (40, 4)
    model = train_deeptica(feats, DeepTICAConfig(
        lag=2, n_out=1, hidden=(8,), max_epochs=4, batch_size=16,
        early_stopping_patience=4, val_fraction=0.3, seed=1), device="cpu")
    cv_fn = make_feature_cv_fn(
        make_phi_psi_feature_fn(info.atom_names, info.residue_ids), model.as_function())
    bias_fn = make_cv_bias_fn(cv_fn, HarmonicExpansionBias(strength=2.0))
    e, f = bias_energy_and_forces(bias_fn, positions)
    assert np.isfinite(float(e)) and bool(torch.isfinite(f).all())
    assert float(f.abs().max()) > 0.0

    biased = ReplicaExchange(system, positions, cfg, device="cpu", bias_fn=bias_fn)
    out = biased.run(100)
    assert np.isfinite(out.positions).all()
    assert 0.0 <= out.mean_acceptance <= 1.0
    # the swap energies are the biased ones
    x_last = torch.as_tensor(out.positions[-1])
    e_phys, _ = make_force_fn(system)(x_last)
    np.testing.assert_allclose(out.potential_energy[-1],
                               (e_phys + bias_fn(x_last)).detach().numpy(), rtol=1e-4)


def test_metadynamics_biased_md(alanine):
    """Well-tempered metadynamics on two phi/psi features inside plain MD."""
    system, positions, info = alanine
    feature_fn = make_phi_psi_feature_fn(info.atom_names, info.residue_ids)
    cv_fn = lambda pos: feature_fn(pos)[..., :2]           # noqa: E731
    mtd = MetadynamicsBias(sigma=(0.3, 0.3), height=2.0, max_hills=32,
                           bias_factor=6.0, temperature_K=300.0)
    hills = mtd.init_state(2)
    state = thermalize(system, positions, torch.Generator().manual_seed(0), 300.0)
    for _ in range(3):
        state, _ = run_md(system, state, n_steps=40, dt=0.002, friction=1.0,
                          temperature_K=300.0, report_interval=20,
                          bias_fn=mtd.bias_fn(hills, cv_fn))
        hills = mtd.deposit(hills, cv_fn(state.positions))
    assert int(hills.n_hills) == 3
    assert bool(torch.isfinite(state.positions).all())
    assert float(mtd.energy(hills, cv_fn(state.positions))) > 0.0


def test_run_replica_exchange_takes_a_bias_fn():
    """``bias_fn=`` runs on the plain path and raises with the kernel."""
    bias_fn = lambda x: 5.0 * (x[..., 0, :] - x[..., 5, :]).pow(2).sum(-1)  # noqa: E731
    cfg = RemdConfig(n_replicas=2, t_min=300.0, t_max=350.0, exchange_frequency=10,
                     report_interval=10, seed=1)
    res, system = run_replica_exchange(
        alanine_dipeptide_structure(), n_steps=20, config=cfg, device="cpu",
        bias_fn=bias_fn)
    assert res.positions.shape == (2, 2, system.n_atoms, 3)
    assert np.isfinite(res.potential_energy).all()
    free, _ = run_replica_exchange(
        alanine_dipeptide_structure(), n_steps=20, config=cfg, device="cpu")
    assert not np.allclose(res.potential_energy, free.potential_energy)
