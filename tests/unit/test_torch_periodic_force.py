"""The dense periodic force path (``pmarlo_tpu_torch/md/periodic_force.py``,
``forces.periodic_nonbonded_energy``): its plain version against the JAX
package's Pallas periodic kernel (run in interpret mode on the CPU) and
against JAX's dense ``periodic_nonbonded_energy`` under ``jax.grad``, on a
small water box and on the shipped solvated chignolin, with and without
the LJ switch; and the CUDA kernel against the plain version on the card.

JAX is imported inside the tests that compare against it, so that the
``gpu`` test also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_periodic_force.py``.

Tolerances: energies to 1e-5 relative and forces to 1e-4 of max |F|: JAX
sums N^2 float32 terms in another order, and the port's plain version
evaluates its pair terms in float64.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.io.pdb import read_pdb
from pmarlo_tpu_torch.md import periodic_force
from pmarlo_tpu_torch.md.cells import ExclusionBand
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.forces import (
    energy_and_forces_autograd,
    lj_switch,
    periodic_nonbonded_energy,
)
from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn
from pmarlo_tpu_torch.md.system import system_from_numpy

ROOT = Path(__file__).resolve().parents[2]
SOLVATED = ROOT / "examples" / "outputs" / "explicit_solvent" / "chignolin_solvated.pdb"
WATER_CUTOFF = 0.6       # a 5^3 box is 1.65 nm wide: more than 2 x 0.6


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_structure(s):
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure

    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    return PDBStructure(residues=residues, box=s.box)


def _jax_water(switch):
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s, box = water_box_structure(5)
    return jax_build_system(_jax_structure(s), box=box, cutoff=WATER_CUTOFF,
                            switch_distance=switch, hydrogen_mass=None)


def _noisy(x, R, seed, sigma):
    rng = np.random.default_rng(seed)
    return (np.asarray(x)[None] + rng.normal(0.0, sigma, (R,) + tuple(np.shape(x)))
            ).astype(np.float32)


def _assert_close(e, f, e_ref, f_ref, what):
    e, f, e_ref, f_ref = (np.asarray(a, np.float64) for a in (e, f, e_ref, f_ref))
    assert np.abs(e - e_ref).max() <= 1e-5 * np.abs(e_ref).max(), what
    assert np.abs(f - f_ref).max() <= 1e-4 * np.abs(f_ref).max(), what


def test_lj_switch_matches_jax():
    import jax.numpy as jnp
    from pmarlo_tpu.md.forces import lj_switch as jax_lj_switch

    r = np.linspace(0.3, 1.0, 141).astype(np.float32)
    s, ds = lj_switch(torch.tensor(r), 0.7, 0.9)
    sj, dsj = jax_lj_switch(jnp.asarray(r), 0.7, 0.9)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), np.asarray(dsj), atol=2e-5)
    assert float(s[0]) == 1.0 and float(s[-1]) == 0.0


@pytest.mark.parametrize("switch", [None, 0.5], ids=["shifted", "switched"])
def test_water_box_matches_jax_kernel_and_oracle(switch):
    """Plain version on a 375-atom water box (two perturbed copies)
    against the Pallas kernel in interpret mode and against jax.grad of the
    dense periodic energy; the port's own dense oracle agrees too."""
    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.md.forces import potential_energy as jax_potential_energy
    from pmarlo_tpu.md.pallas_periodic import build_periodic_force_fn as jax_build

    jsys, jx = _jax_water(switch)
    system = system_from_numpy(jsys.to_dict())
    assert system.box == tuple(jsys.box) and system.cutoff == WATER_CUTOFF
    assert system.switch_distance == switch and system.tilt is None
    xs = _noisy(jx, 2, seed=3, sigma=0.02)
    fn = build_periodic_force_fn(system)
    assert fn.band_D == 2
    e, f = fn(torch.tensor(xs))
    jfn = jax_build(jsys, tile=128, interpret=True)
    grad = jax.value_and_grad(lambda p: jax_potential_energy(jsys, p))
    for r in range(2):
        ek, fk = jfn(jnp.asarray(xs[r]))
        _assert_close(e[r], f[r], ek, fk, "Pallas periodic kernel (interpret)")
        eo, go = grad(jnp.asarray(xs[r]))
        _assert_close(e[r], f[r], eo, -np.asarray(go), "jax.grad of the dense energy")
    eo, fo = energy_and_forces_autograd(system, torch.tensor(xs).double())
    _assert_close(e, f, eo, fo, "the port's dense oracle")
    # one configuration without the batch dimension
    e1, f1 = fn(torch.tensor(xs[0]))
    assert e1.shape == () and torch.equal(f1, f[0])


def test_periodic_oracle_matches_jax():
    """``forces.periodic_nonbonded_energy`` against JAX's, batched."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.forces import periodic_nonbonded_energy as jax_energy

    for switch in (None, 0.5):
        jsys, jx = _jax_water(switch)
        system = system_from_numpy(jsys.to_dict())
        xs = _noisy(jx, 2, seed=5, sigma=0.02)
        e = periodic_nonbonded_energy(system, torch.tensor(xs))
        ej = np.array([float(jax_energy(jsys, jnp.asarray(x))) for x in xs])
        np.testing.assert_allclose(e.numpy(), ej, rtol=1e-5)


def test_solvated_chignolin_matches_jax_kernel_and_oracle():
    """The shipped 2,315-atom solvated chignolin at full width, cutoff 0.9:
    the band covers the protein's exclusions, the far list is empty or
    short, 1-4 pairs come back as uncut scaled Coulomb."""
    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.io.pdb import read_pdb as jax_read_pdb
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu.md.forces import potential_energy as jax_potential_energy
    from pmarlo_tpu.md.pallas_periodic import build_periodic_force_fn as jax_build

    st = jax_read_pdb(SOLVATED)
    jsys, jx = jax_build_system(st, box=st.box, cutoff=0.9)
    system, x0 = build_system(read_pdb(SOLVATED), box=st.box, cutoff=0.9, device="cpu")
    assert system.n_atoms == 2315 and system.box == tuple(st.box)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx), atol=1e-6)
    x = _noisy(jx, 1, seed=7, sigma=0.01)[0]
    fn = build_periodic_force_fn(system)
    assert fn.band_D >= 10
    e, f = fn(torch.tensor(x))
    ek, fk = jax_build(jsys, interpret=True)(jnp.asarray(x))
    _assert_close(e, f, ek, fk, "Pallas periodic kernel (interpret)")
    eo, go = jax.value_and_grad(lambda p: jax_potential_energy(jsys, p))(jnp.asarray(x))
    _assert_close(e, f, eo, -np.asarray(go), "jax.grad of the dense energy")


def test_band_from_jax_arrays_and_no_dense_tables():
    """The exclusion band built from JAX's own arrays gives the same
    numbers, and the sweep needs no (N, N) scale matrices."""
    import dataclasses

    from pmarlo_tpu.md import cells as jcells

    jsys, jx = _jax_water(None)
    system = system_from_numpy(jsys.to_dict())
    D = jcells.exclusion_band_width(jsys)
    band = ExclusionBand.from_numpy(D, *jcells.banded_scales(jsys, D))
    x = torch.tensor(_noisy(jx, 1, seed=9, sigma=0.02))
    e0, f0 = build_periodic_force_fn(system)(x)
    e1, f1 = build_periodic_force_fn(system, band=band)(x)
    assert torch.equal(e0, e1) and torch.equal(f0, f1)
    bare = dataclasses.replace(system, scale_elec=None, scale_lj=None)
    e2, f2 = build_periodic_force_fn(bare)(x)
    assert torch.equal(e0, e2) and torch.equal(f0, f2)
    with pytest.raises(ValueError, match="dense"):
        periodic_nonbonded_energy(bare, x)


def test_refusals_keep_their_meaning():
    s, box = water_box_structure(5)
    system, x = build_system(s, box=box, cutoff=WATER_CUTOFF, hydrogen_mass=None,
                             device="cpu")
    import dataclasses

    with pytest.raises(ValueError, match="needs system.box"):
        build_periodic_force_fn(dataclasses.replace(system, box=None))
    with pytest.raises(ValueError, match="orthorhombic-only"):
        build_periodic_force_fn(dataclasses.replace(system, tilt=(0.1, 0.0, 0.0)))
    fn = build_periodic_force_fn(system)
    with pytest.raises(TypeError, match="float32"):
        fn(x.double())
    with pytest.raises(ValueError, match="must be"):
        fn(x[:10])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["water_375", "chignolin_2315", "chignolin_switched"])
def test_kernel_matches_plain_version_on_the_card(which):
    """``periodic_force_kernel`` against its plain version on the same card
    tensors (R = 8): energy rows and the whole energy to 1e-5, forces to
    1e-4 of max |F|; one launch an evaluation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if which == "water_375":
        s, box = water_box_structure(5)
        system, pos = build_system(s, box=box, cutoff=WATER_CUTOFF, hydrogen_mass=None,
                                   device="cuda")
    else:
        st = read_pdb(SOLVATED)
        system, pos = build_system(
            st, box=st.box, cutoff=0.9, device="cuda",
            switch_distance=0.8 if which.endswith("switched") else None)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), 8, seed=4, sigma=0.01), device="cuda")
    fn = build_periodic_force_fn(system)
    before = periodic_force.launches["periodic_force"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    ek, fk = fn.sweep(x)
    ep, fp = fn.sweep_reference(x)
    assert rel(ek, ep) <= 1e-5 and rel(fk, fp) <= 1e-4
    e, f = fn(x)
    er, fr = fn.reference(x)
    torch.cuda.synchronize()
    assert rel(e, er) <= 1e-5 and rel(f, fr) <= 1e-4
    assert bool(torch.isfinite(f).all())
    assert periodic_force.launches["periodic_force"] - before == 2
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        fn._launch(x.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["tip4pew", "tip5p"])
def test_kernel_on_site_water_matches_plain_version_on_the_card(model):
    """Row 8 on virtual-site water (729 TIP4P-Ew or TIP5P waters, R = 4):
    the sweep over the expanded positions, the sites charged atoms without
    LJ, against its plain version, and the whole site-correct evaluation
    against ``reference``; energy to 1e-5, forces to 1e-4 of max |F|, zero
    force on the site rows, one launch a sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    s, box = water_box_structure(9, water_model=model, seed=0)
    system, pos = build_system(s, box=box, cutoff=0.9, hydrogen_mass=None, device="cuda")
    fn = build_periodic_force_fn(system)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), 4, seed=5, sigma=0.01), device="cuda")
    xe = fn.vsites.expand(x)
    before = periodic_force.launches["periodic_force"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    ek, fk = fn.sweep(xe)
    ep, fp = fn.sweep_reference(xe)
    assert rel(ek, ep) <= 1e-5 and rel(fk, fp) <= 1e-4
    e, f = fn(x)
    er, fr = fn.reference(x)
    torch.cuda.synchronize()
    assert rel(e, er) <= 1e-5 and rel(f, fr) <= 1e-4
    assert bool(torch.isfinite(f).all())
    assert (f[:, system.vsite_idx[:, 0].long()] == 0.0).all()
    assert periodic_force.launches["periodic_force"] - before == 2
