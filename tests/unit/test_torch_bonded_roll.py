"""The roll-layout bonded terms (``md/bonded_roll.py``) against the JAX
package's and against the port's own bonded terms (``md/forces.py``).

Alanine (at its built geometry and 0.02 nm off it) and the 138-atom
chignolin. Tolerances: energies to 1e-5 relative, forces (autograd) to
1e-4 of the largest.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.md import forces
from pmarlo_tpu_torch.md.bonded_roll import _layered_groups, build_rolled_bonded
from pmarlo_tpu_torch.md.system import system_from_numpy

jax = pytest.importorskip("jax")
jnp = jax.numpy

CASES = {
    "alanine": (alanine_dipeptide_structure, 0.0),
    "alanine_perturbed": (alanine_dipeptide_structure, 0.02),
    "chignolin": (chignolin_structure, 0.0),
}


@pytest.fixture(scope="module")
def systems():
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure
    from pmarlo_tpu.md.forcefield import build_system

    cache = {}

    def get(name):
        if name not in cache:
            make, sigma = CASES[name]
            s = make()
            js, jx = build_system(PDBStructure(residues=[
                PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
                    PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                            xyz=a.xyz, element=a.element) for a in r.atoms])
                for r in s.residues]), gb_model="gbn2")
            rng = np.random.default_rng(31)
            x = (np.asarray(jx) + rng.normal(0.0, sigma, np.shape(jx))).astype(np.float32)
            cache[name] = (js, system_from_numpy(js.to_dict(), device="cpu"), x)
        return cache[name]

    return get


TERMS = {
    "bond": ("bond_idx", ("bond_k", "bond_r0")),
    "angle": ("angle_idx", ("angle_k", "angle_t0")),
    "torsion": ("torsion_idx", ("torsion_k", "torsion_n", "torsion_phase")),
}


@pytest.mark.parametrize("term", sorted(TERMS))
@pytest.mark.parametrize("name", ["alanine", "chignolin"])
def test_layered_groups_match_their_source(systems, name, term):
    """The copied grouping, held against the JAX package's: the same
    signatures, masks and parameter planes in the same order; every term in
    exactly one layer; no base atom twice in a layer."""
    from pmarlo_tpu.md.bonded_roll import _layered_groups as jax_groups

    js, _, _ = systems(name)
    idx_name, param_names = TERMS[term]
    idx = np.asarray(getattr(js, idx_name))
    params = [np.asarray(getattr(js, p)) for p in param_names]
    got = _layered_groups(idx, params, js.n_atoms)
    want = jax_groups(idx, params, js.n_atoms)
    assert len(got) == len(want)
    for (gs, gm, gp), (ws, wm, wp) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)
        assert len(gp) == len(wp)
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, b)
    # each term sits in one layer of its signature, at its base atom
    assert sum(int(m.sum()) for _, m, _ in got) == idx.shape[0]
    for sig in {s for s, _, _ in got}:
        rows = idx[[tuple(int(d) for d in r[1:] - r[0]) == sig for r in idx]]
        layers = [m for s, m, _ in got if s == sig]
        bases, counts = np.unique(rows[:, 0], return_counts=True)
        assert len(layers) == counts.max()
        np.testing.assert_array_equal(np.sum(layers, axis=0)[bases], counts)
    if term == "torsion":
        # Fourier multiplicities of one quadruple go into separate layers
        sigs = [s for s, _, _ in got]
        assert len(sigs) > len(set(sigs))


def test_empty_term_list_has_no_groups():
    assert _layered_groups(np.zeros((0, 2), np.int32), [np.zeros(0)], 5) == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_rolled_energy_and_forces_match_jax_and_the_index_terms(systems, name):
    from pmarlo_tpu.md.bonded_roll import build_rolled_bonded as jax_rolled

    js, ts, x = systems(name)
    jfn = jax_rolled(js)
    je, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(x))
    fn = build_rolled_bonded(ts)
    y = torch.from_numpy(x).requires_grad_(True)
    te = fn(y)
    (tg,) = torch.autograd.grad(te, y)
    te = te.detach()
    assert te.shape == () and te.dtype == torch.float32
    assert abs(float(te) - float(je)) <= 1e-5 * abs(float(je))
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()

    z = torch.from_numpy(x).requires_grad_(True)
    ref = (forces.bond_energy(ts, z) + forces.angle_energy(ts, z)
           + forces.torsion_energy(ts, z))
    (rg,) = torch.autograd.grad(ref, z)
    ref = ref.detach()
    assert abs(float(te) - float(ref)) <= 1e-5 * abs(float(ref))
    assert np.abs(tg.numpy() - rg.numpy()).max() <= 1e-4 * np.abs(rg.numpy()).max()


def test_rolled_energy_batches_over_leading_dimensions(systems):
    _, ts, x = systems("alanine_perturbed")
    rng = np.random.default_rng(32)
    xs = torch.from_numpy((x + rng.normal(0.0, 0.01, (3,) + x.shape)).astype(np.float32))
    fn = build_rolled_bonded(ts)
    batched = fn(xs)
    assert batched.shape == (3,)
    for r in range(3):
        assert abs(float(batched[r]) - float(fn(xs[r]))) <= 1e-5 * abs(float(fn(xs[r])))
