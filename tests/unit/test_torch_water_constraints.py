"""Rigid-water constraints (``pmarlo_tpu_torch/md/constraints.py``:
``RigidWaterSpec``, ``shake_water``, ``rattle_water``,
``CompositeConstraintSpec``) against the JAX package on the same
numpy-seeded inputs: a 27-water box and alanine dipeptide in 5^3 lattice
waters (a solute's X-H bonds beside the water block).

Tolerances: one SHAKE projection to 1e-6 nm of JAX's (both run six Newton
iterations of the same 3x3 solve in float32) from positions 0.003 nm off
the manifold, the size of an MD position update; one RATTLE projection of
velocities of order 1 nm/ps, both at the port's SHAKEn positions, to 3e-6
nm/ps (float32 rounding of the 3x3 solve: JAX's own result lies 1.1e-6
from a float64 solve); the constraint
manifold itself to 1e-5 nm. From 0.01 nm off the manifold JAX's float32
Newton iteration stops 2.7e-4 nm short, so there the port is held to its
own float64 solve instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.io.pdb import PDBStructure
from pmarlo_tpu_torch.md.constraints import (
    CompositeConstraintSpec,
    ConstraintSpec,
    RigidWaterSpec,
    _solve33,
    build_h_constraints,
    constraint_violation,
    n_constraints,
    rattle,
    rattle_water,
    shake,
    shake_water,
    strip_constrained_bonded,
)
from pmarlo_tpu_torch.md.system import system_from_numpy


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
    return PDBStructure(residues=solute.residues + kept, box=box), box


def _jax_structure(s):
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure as JaxStructure

    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    return JaxStructure(residues=residues, box=s.box)


@pytest.fixture(scope="module", params=["water_box", "solvated_alanine"])
def wet(request):
    """JAX system, positions and constraint spec, and the port's system
    built from the JAX arrays."""
    from pmarlo_tpu.md.constraints import build_h_constraints as jax_constraints
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    if request.param == "water_box":
        s, box = water_box_structure(3, spacing=0.5, margin=0.0)
        hmr = None
    else:
        s, box = solvated_alanine()
        hmr = 3.0
    js, jx = jax_build_system(_jax_structure(s), box=box, cutoff=0.6, hydrogen_mass=hmr)
    return js, np.array(jx), jax_constraints(js), system_from_numpy(js.to_dict())


def test_water_spec_matches_jax(wet):
    js, _, jspec, ts = wet
    spec = build_h_constraints(ts)
    assert isinstance(spec, CompositeConstraintSpec)
    ref = RigidWaterSpec.from_numpy(jspec.water)
    w = spec.water
    assert (w.start, w.n_waters, w.n_newton) == (ref.start, ref.n_waters, ref.n_newton)
    assert w.n_newton == 6 and w.start + 3 * w.n_waters == ts.n_atoms
    torch.testing.assert_close(w.inv_m, ref.inv_m, rtol=1e-6, atol=0)
    torch.testing.assert_close(w.d0, ref.d0, rtol=0, atol=0)
    assert (spec.protein is None) == (jspec.protein is None)


def test_n_constraints_and_stripping_match_jax(wet):
    from pmarlo_tpu.md.constraints import n_constraints as jax_n_constraints
    from pmarlo_tpu.md.constraints import strip_constrained_bonded as jax_strip

    js, _, jspec, ts = wet
    spec = build_h_constraints(ts)
    assert n_constraints(spec) == spec.n_constraints == jax_n_constraints(jspec)
    assert spec.n_constraints == n_constraints(spec.protein) + 3 * spec.water.n_waters
    ours, theirs = strip_constrained_bonded(ts), jax_strip(js)
    for name in ("bond_idx", "bond_k", "bond_r0", "angle_idx", "angle_k", "angle_t0"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)), err_msg=name)


def test_shake_and_rattle_water_match_jax(wet):
    """One exact SHAKE of waters pushed 0.003 nm off the manifold and one
    exact RATTLE of random velocities, batched over three replicas on the
    port's side, against JAX's."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.constraints import rattle_water as jax_rattle_water
    from pmarlo_tpu.md.constraints import shake_water as jax_shake_water

    _, jx, jspec, ts = wet
    w = build_h_constraints(ts).water
    rng = np.random.default_rng(0)
    x_new = (jx[None] + rng.normal(0.0, 0.003, (3,) + jx.shape)).astype(np.float32)
    v = rng.normal(0.0, 1.0, (3,) + jx.shape).astype(np.float32)
    xs = shake_water(w, torch.from_numpy(x_new), torch.from_numpy(jx))
    vs = rattle_water(w, torch.from_numpy(v), xs)
    for r in range(3):
        jxs = jax_shake_water(jspec.water, jnp.asarray(x_new[r]), jnp.asarray(jx))
        jvs = jax_rattle_water(jspec.water, jnp.asarray(v[r]), jnp.asarray(xs[r].numpy()))
        np.testing.assert_allclose(xs[r].numpy(), np.asarray(jxs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(vs[r].numpy(), np.asarray(jvs), rtol=0, atol=3e-6)
    assert float(constraint_violation(w, xs)) <= 1e-5
    assert float(constraint_violation(w, torch.from_numpy(x_new))) > 1e-3
    # atoms outside the water block are left alone
    assert torch.equal(xs[:, :w.start], torch.from_numpy(x_new)[:, :w.start])
    # after RATTLE no bond of a water changes length to first order
    blk = slice(w.start, None)
    xb = xs[:, blk].unflatten(-2, (w.n_waters, 3))
    vb = vs[:, blk].unflatten(-2, (w.n_waters, 3))
    for i, j in ((0, 1), (0, 2), (1, 2)):
        rate = ((xb[..., i, :] - xb[..., j, :]) * (vb[..., i, :] - vb[..., j, :])).sum(-1)
        assert float(rate.abs().max()) <= 1e-5


def test_composite_shake_and_rattle_match_jax(wet):
    """The composite spec through ``shake`` / ``rattle`` (X-H Jacobi sweeps,
    then the exact water solve) against JAX's composite."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.constraints import constraint_violation as jax_violation
    from pmarlo_tpu.md.constraints import rattle as jax_rattle
    from pmarlo_tpu.md.constraints import shake as jax_shake

    _, jx, jspec, ts = wet
    spec = build_h_constraints(ts)
    rng = np.random.default_rng(1)
    x_new = (jx[None] + rng.normal(0.0, 0.003, (2,) + jx.shape)).astype(np.float32)
    v = rng.normal(0.0, 1.0, (2,) + jx.shape).astype(np.float32)
    xs = shake(spec, torch.from_numpy(x_new), torch.from_numpy(jx))
    vs = rattle(spec, torch.from_numpy(v), xs)
    for r in range(2):
        jxs = jax_shake(jspec, jnp.asarray(x_new[r]), jnp.asarray(jx))
        jvs = jax_rattle(jspec, jnp.asarray(v[r]), jnp.asarray(xs[r].numpy()))
        np.testing.assert_allclose(xs[r].numpy(), np.asarray(jxs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(vs[r].numpy(), np.asarray(jvs), rtol=0, atol=3e-6)
        assert abs(float(constraint_violation(spec, xs[r]))
                   - float(jax_violation(jspec, jxs))) <= 1e-6
    assert float(constraint_violation(spec, xs)) <= 1e-5


def test_shake_water_converges_from_far_off(wet):
    """From 0.01 nm off the manifold the float32 solve lands within 1e-6
    nm of a float64 solve with twice the Newton iterations."""
    _, jx, _, ts = wet
    w = build_h_constraints(ts).water
    rng = np.random.default_rng(3)
    x_new = (jx[None] + rng.normal(0.0, 0.01, (3,) + jx.shape)).astype(np.float32)
    xs = shake_water(w, torch.from_numpy(x_new), torch.from_numpy(jx))
    w64 = RigidWaterSpec(start=w.start, n_waters=w.n_waters, inv_m=w.inv_m.double(),
                         d0=w.d0.double(), n_newton=12)
    ref = shake_water(w64, torch.from_numpy(x_new).double(), torch.from_numpy(jx).double())
    assert float((xs.double() - ref).abs().max()) <= 1e-6
    assert float(constraint_violation(w, xs)) <= 1e-6


def test_solve33_matches_numpy():
    rng = np.random.default_rng(2)
    A = rng.normal(0.0, 1.0, (4, 50, 3, 3)) + 3.0 * np.eye(3)
    b = rng.normal(0.0, 1.0, (4, 50, 3))
    got = _solve33(torch.tensor(A), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(A, b[..., None])[..., 0], atol=1e-12)


def test_spec_carriers_and_refusals():
    s, box = water_box_structure(2, spacing=0.7, margin=0.0)
    from pmarlo_tpu_torch.md.forcefield import build_system

    system, _ = build_system(s, box=box, cutoff=0.6, device="cpu")
    spec = build_h_constraints(system)
    moved = spec.to("cpu")
    assert isinstance(moved, CompositeConstraintSpec) and moved.water.n_waters == 8
    assert moved.protein is None and moved.n_constraints == 24
    # four-site water carries its stride; a block whose names break the
    # layout of its stride is refused
    four = dataclasses.make_dataclass("Spec", ["start", "n_waters", "inv_m", "d0",
                                               "n_newton", "stride"])
    assert RigidWaterSpec.from_numpy(four(0, 8, np.ones(3), np.ones(3), 6, 4),
                                     device="cpu").stride == 4
    names = list(system.atom_names)
    names[3] = "M"
    with pytest.raises(ValueError, match="contiguous"):
        build_h_constraints(dataclasses.replace(system, atom_names=tuple(names)))
    # the X-H spec of a dry system is still the plain one
    from pmarlo_tpu_torch.md.forcefield import build_system as build

    dry, _ = build(alanine_dipeptide_structure(), device="cpu")
    assert isinstance(build_h_constraints(dry), ConstraintSpec)
