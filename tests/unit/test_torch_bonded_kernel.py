"""The bonded kernel's wrapper (``pmarlo_tpu_torch/md/bonded_window.py``)
against the JAX package's windowed Pallas bonded kernel (``interpret=True``
on the CPU) and against autograd of the port's own bonded energies, on the
systems of ``tests/unit/test_bonded_window.py``; the per-atom CSR the kernel
walks; and the kernel against its plain version on the card (``gpu``-marked;
skips here).

JAX is imported inside the tests that compare against it, so that the
``gpu`` tests also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_bonded_kernel.py``.

Tolerances: energy to 1e-5 relative, gradient to 1e-4 of max |dE/dx|
(float32 rounding; JAX's arccos is a polynomial with one Newton step, ~1e-7
rad).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure, replicate_structure
from pmarlo_tpu_torch.md import bonded_window
from pmarlo_tpu_torch.md.bonded_window import bonded_csr, build_bonded_window
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.forces import angle_energy, bond_energy, torsion_energy
from pmarlo_tpu_torch.md.system import system_from_numpy


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assembly(reps, spacing=(1.1, 1.1, 1.1)):
    return replicate_structure(alanine_dipeptide_structure(), n=reps, spacing=spacing)


def _autograd(system, x):
    """Energy and dE/dx of ``md/forces.py``'s bonded energies (float64)."""
    s64 = dataclasses.replace(system, **{
        f.name: getattr(system, f.name).double() for f in dataclasses.fields(system)
        if isinstance(getattr(system, f.name), torch.Tensor)
        and getattr(system, f.name).is_floating_point()})
    y = x.double().requires_grad_(True)
    e = bond_energy(s64, y) + angle_energy(s64, y) + torsion_energy(s64, y)
    (g,) = torch.autograd.grad(e.sum(), y)
    return e.detach(), g


def _jax_pair(reps, distort=0.0, seed=0):
    """JAX system and positions, the port's system from the same arrays."""
    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
    from pmarlo_tpu.data import replicate_structure as jax_replicate
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    js, jx = jax_build_system(
        jax_replicate(jax_alanine(), n=reps, spacing=(1.1, 1.1, 1.1)), gb_model="gbn2")
    x = np.array(jx, np.float32)
    if distort:
        x = (x + distort * np.random.default_rng(seed).standard_normal(x.shape)
             ).astype(np.float32)
    return js, x, system_from_numpy(js.to_dict())


def _close(e, g, e_ref, g_ref):
    e, e_ref = np.asarray(e, np.float64), np.asarray(e_ref, np.float64)
    assert np.abs(e - e_ref).max() <= 1e-5 * np.abs(e_ref).max()
    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    assert np.abs(g - g_ref).max() <= 1e-4 * np.abs(g_ref).max()


@pytest.mark.parametrize("reps,distort", [((1, 1, 1), 0.0), ((3, 2, 1), 0.0),
                                          ((2, 2, 1), 0.02)],
                         ids=["22_atoms", "132_atoms", "88_atoms_distorted"])
def test_matches_jax_window_kernel_and_autograd(reps, distort):
    import jax.numpy as jnp
    from pmarlo_tpu.md.bonded_window import build_bonded_window as jax_window

    js, x, ts = _jax_pair(reps, distort)
    je, jg = jax_window(js, stride=128, interpret=True)(jnp.asarray(x))
    fn = build_bonded_window(ts)
    e, g = fn(torch.from_numpy(x))
    assert e.shape == () and e.dtype == torch.float32 and g.shape == x.shape
    _close(e, g, je, np.asarray(jg))
    ea, ga = _autograd(ts, torch.from_numpy(x))
    _close(e, g, ea, ga)
    if distort:
        assert float(g.abs().max()) > 1e3     # every gradient branch carries signal


def test_long_span_bond_needs_no_fallback():
    """A bond from the first to the last of 352 atoms is a "far" term of
    JAX's windows (its fallback path); here it is a term like any other."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.bonded_window import build_bonded_window as jax_window

    js, x, ts = _jax_pair((16, 1, 1))
    n = ts.n_atoms
    extra = dict(bond_idx=[[0, n - 1]], bond_k=[1000.0], bond_r0=[1.0])
    js2 = dataclasses.replace(js, **{
        k: np.concatenate([np.asarray(getattr(js, k)), np.asarray(v, np.asarray(
            getattr(js, k)).dtype)]) for k, v in extra.items()})
    ts2 = system_from_numpy(js2.to_dict())
    jfn = jax_window(js2, stride=128, interpret=True)
    assert jfn.far_terms >= 1
    je, jg = jfn(jnp.asarray(x))
    fn = build_bonded_window(ts2)
    assert fn.far_terms == 0
    e, g = fn(torch.from_numpy(x))
    _close(e, g, je, np.asarray(jg))
    _close(e, g, *_autograd(ts2, torch.from_numpy(x)))
    e1, _ = build_bonded_window(ts)(torch.from_numpy(x))
    assert float(e) > float(e1) + 100.0        # the long bond is stretched


def test_no_bonded_terms_returns_none():
    system, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")
    dev = system.device
    empty = dataclasses.replace(
        system,
        bond_idx=torch.zeros((0, 2), dtype=torch.int32, device=dev),
        bond_k=torch.zeros(0), bond_r0=torch.zeros(0),
        angle_idx=torch.zeros((0, 3), dtype=torch.int32, device=dev),
        angle_k=torch.zeros(0), angle_t0=torch.zeros(0),
        torsion_idx=torch.zeros((0, 4), dtype=torch.int32, device=dev),
        torsion_k=torch.zeros(0), torsion_n=torch.zeros(0), torsion_phase=torch.zeros(0))
    assert build_bonded_window(empty) is None
    # the pair path then adds zero bonded terms
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    x = _assembly((1, 1, 1))
    _, pos = build_system(x, gb_model="gbn2", device="cpu")
    e_w, f_w = build_pair_force_fn(empty, gb_cutoff=2.0, bonded="window")(pos)
    e_g, f_g = build_pair_force_fn(empty, gb_cutoff=2.0, bonded="gather")(pos)
    assert torch.equal(e_w, e_g) and torch.equal(f_w, f_g)


def test_batches_energy_type_and_shape_checks():
    system, pos = build_system(_assembly((2, 1, 1)), gb_model="gbn2", device="cpu")
    fn = build_bonded_window(system)
    rng = np.random.default_rng(1)
    x = pos[None] + torch.as_tensor(rng.normal(0.0, 0.01, (3,) + tuple(pos.shape)),
                                    dtype=torch.float32)
    e, g = fn(x, energy_dtype=torch.float64)
    assert e.shape == (3,) and e.dtype == torch.float64 and g.shape == x.shape
    for r in range(3):
        e1, g1 = fn(x[r])
        torch.testing.assert_close(e1.double(), e[r], rtol=1e-6, atol=0)
        torch.testing.assert_close(g1, g[r], rtol=0, atol=0)
    before = dict(bonded_window.launches)
    with pytest.raises(ValueError, match="must be"):
        fn(x[:, :5])
    with pytest.raises(RuntimeError, match="CUDA"):
        fn._launch(x, None)
    assert bonded_window.launches == before == {"bonded": 0}


def test_bonded_csr_lists_every_incidence_in_a_fixed_order():
    """The vectorized CSR against the straightforward loops: every (type,
    role, term) once, under its atom, ordered by type, term, role."""
    system, _ = build_system(_assembly((2, 2, 1)), gb_model="gbn2", device="cpu")
    tables = [t.numpy() for t in (system.bond_idx, system.angle_idx, system.torsion_idx)]
    ptr, ent = bonded_csr(*tables, system.n_atoms)
    per_atom = [[] for _ in range(system.n_atoms)]
    for ttype, idx in enumerate(tables):
        for term, atoms in enumerate(idx):
            for role, atom in enumerate(atoms):
                per_atom[int(atom)].append((ttype << 2 | role, term))
    assert ptr.dtype == ent.dtype == np.int32
    assert ptr.tolist() == np.concatenate([[0], np.cumsum([len(e) for e in per_atom])]).tolist()
    assert ent.tolist() == [list(e) for lst in per_atom for e in lst]
    # no terms at all: an empty list under every atom
    ptr0, ent0 = bonded_csr(np.zeros((0, 2)), np.zeros((0, 3)), np.zeros((0, 4)), 5)
    assert ptr0.tolist() == [0] * 6 and ent0.shape == (0, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("reps", [(1, 1, 1), (6, 5, 4), (12, 12, 8)],
                         ids=["22_atoms", "2640_atoms", "25344_atoms"])
def test_kernel_matches_plain_version_on_the_card(reps):
    """``csrc/bonded.cu`` against ``bonded_energy_and_forces`` on the same
    card tensors (R = 3, distorted) and against float64 autograd: energy to
    1e-5 relative, gradient to 1e-4 of its max; one launch a call, and the
    same bits from a second launch (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    system, pos = build_system(_assembly(reps), gb_model="gbn2", device="cuda",
                               dense_scales=False)
    rng = np.random.default_rng(9)
    x = pos[None] + torch.as_tensor(rng.normal(0.0, 0.01, (3,) + tuple(pos.shape)),
                                    dtype=torch.float32, device="cuda")
    fn = build_bonded_window(system)
    before = bonded_window.launches["bonded"]
    e, g = fn(x, energy_dtype=torch.float64)
    e2, g2 = fn(x, energy_dtype=torch.float64)
    torch.cuda.synchronize()
    assert bonded_window.launches["bonded"] == before + 2
    assert torch.equal(e, e2) and torch.equal(g, g2)
    ep, gp = fn.reference(x, energy_dtype=torch.float64)
    _close(e.cpu(), g.cpu(), ep.cpu(), gp.cpu())
    ea, ga = _autograd(system, x)
    _close(e.cpu(), g.cpu(), ea.cpu(), ga.cpu())
