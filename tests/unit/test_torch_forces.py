"""Port parity: analytic energies and forces against the JAX package's
``analytic.energy_and_forces`` and the port's own autograd reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
from pmarlo_tpu.md import analytic as jax_analytic
from pmarlo_tpu.md.forcefield import build_system as jax_build_system
from pmarlo_tpu.md.forces import dihedral_angles as jax_dihedral_angles
from pmarlo_tpu.md.forces import potential_energy as jax_potential_energy
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.md import analytic
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.forces import (
    dihedral_angles,
    energy_and_forces_autograd,
    potential_energy,
)

#: the reference's own fused-vs-analytic gate (max relative error, float32)
REL_TOL = 1e-4

MODELS = {
    "gbn2": dict(gb_model="gbn2"),
    "obc2": dict(gb_model="obc2"),
    "vacuum": dict(implicit_solvent=False),
}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _systems(model):
    js, jx = jax_build_system(jax_alanine(), **MODELS[model])
    ts, _ = build_system(alanine_dipeptide_structure(), **MODELS[model])
    rng = np.random.default_rng(7)
    x = (np.asarray(jx)[None] + rng.normal(0.0, 0.01, (3, 22, 3))).astype(np.float32)
    return js, ts, x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_energy_and_forces_match_jax(model):
    js, ts, x = _systems(model)
    jp = jax_analytic.make_dense_params(js)
    je, jf = jax.vmap(lambda y: jax_analytic.energy_and_forces(jp, y))(jnp.asarray(x))
    te, tf = analytic.energy_and_forces(analytic.make_dense_params(ts), torch.from_numpy(x))
    assert te.shape == (3,) and tf.shape == (3, 22, 3)
    assert _rel(te.numpy(), je) <= REL_TOL
    assert _rel(tf.numpy(), jf) <= REL_TOL


@pytest.mark.parametrize("model", sorted(MODELS))
def test_analytic_matches_autograd(model):
    _, ts, x = _systems(model)
    te, tf = analytic.energy_and_forces(analytic.make_dense_params(ts), torch.from_numpy(x))
    ae, af = energy_and_forces_autograd(ts, torch.from_numpy(x))
    assert _rel(te.numpy(), ae.numpy()) <= REL_TOL
    assert _rel(tf.numpy(), af.numpy()) <= REL_TOL


@pytest.mark.parametrize("model", sorted(MODELS))
def test_potential_energy_matches_jax(model):
    js, ts, x = _systems(model)
    je = np.asarray(jax.vmap(lambda y: jax_potential_energy(js, y))(jnp.asarray(x)))
    te = potential_energy(ts, torch.from_numpy(x)).numpy()
    assert _rel(te, je) <= REL_TOL


def test_unbatched_positions_give_scalar_energy():
    _, ts, x = _systems("gbn2")
    p = analytic.make_dense_params(ts)
    e1, f1 = analytic.energy_and_forces(p, torch.from_numpy(x[0]))
    e3, f3 = analytic.energy_and_forces(p, torch.from_numpy(x))
    assert e1.shape == () and f1.shape == (22, 3)
    assert _rel(e1.numpy(), e3[0].numpy()) <= 1e-6
    assert _rel(f1.numpy(), f3[0].numpy()) <= 1e-6


def test_dihedral_angles_match_jax():
    js, ts, x = _systems("gbn2")
    idx = np.array(js.torsion_idx)
    ja = np.asarray(jax.vmap(lambda y: jax_dihedral_angles(y, jnp.asarray(idx)))(jnp.asarray(x)))
    ta = dihedral_angles(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    # angles in rad; float32 atan2 of the same cross products
    np.testing.assert_allclose(ta, ja, atol=1e-5, rtol=0)
