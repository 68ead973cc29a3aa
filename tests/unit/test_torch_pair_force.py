"""The protein-scale pair force path (``pmarlo_tpu_torch/md/pair_force.py``,
``md/cells.py``): its plain twins against the JAX package's Pallas pair
kernel (run in interpret mode on the CPU), the exclusion band, the
repaired ``build_system(dense_scales=)``, and the three CUDA kernels
against their twins on the card.

JAX is imported inside the tests that compare against it, so that the
``gpu`` test also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_pair_force.py``.

Tolerances: energies to 1e-5 relative and forces to 1e-4 of max |F|, the
float32 rounding of sums taken in another order.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly, chignolin_structure
from pmarlo_tpu_torch.md import analytic, pair_force
from pmarlo_tpu_torch.md.cells import ExclusionBand, banded_scales, exclusion_band_width
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn
from pmarlo_tpu_torch.md.system import system_from_numpy

STRUCTURES = {
    "alanine_22": lambda: alanine_dipeptide_structure(),
    "chignolin_138": lambda: chignolin_structure(),
    "chignolin_276": lambda: chignolin_assembly((2, 1, 1)),
}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_system(name):
    """The JAX package's system for a structure of ``STRUCTURES``."""
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s = STRUCTURES[name]()
    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    return jax_build_system(PDBStructure(residues=residues), gb_model="gbn2")


def _noisy(x, R, seed=0, sigma=0.01):
    rng = np.random.default_rng(seed)
    return (np.asarray(x)[None] + rng.normal(0.0, sigma, (R,) + tuple(np.shape(x)))
            ).astype(np.float32)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_pair_twin_matches_jax_pair_kernel(name):
    """The port's full evaluation (twins + glue + band add-back + bonded)
    against ``pallas_pair.build_pair_force_fn(tile=128, interpret=True)``
    on the same system and positions."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system(name)
    ts = system_from_numpy(js.to_dict())
    x = _noisy(jx, 1)[0]
    je, jf = jax_pair(js, tile=128, interpret=True)(jnp.asarray(x))
    te, tf = build_pair_force_fn(ts)(torch.from_numpy(x))
    je, jf = float(je), np.asarray(jf)
    assert abs(float(te) - je) <= 1e-5 * abs(je)
    assert np.abs(tf.numpy() - jf).max() <= 1e-4 * np.abs(jf).max()


def test_pair_twin_matches_the_dense_analytic_path():
    """At 276 atoms the dense (N, N) analytic path exists too: same energy
    and forces from the pair path's twins."""
    system, pos = build_system(chignolin_assembly((2, 1, 1)), gb_model="gbn2")
    x = torch.from_numpy(_noisy(pos.numpy(), 2, seed=1))
    e, f = build_pair_force_fn(system).reference(x)
    de, df = analytic.energy_and_forces(analytic.make_dense_params(system), x)
    assert float((e - de).abs().max() / de.abs().max()) <= 1e-5
    assert float((f - df).abs().max() / df.abs().max()) <= 1e-4


def test_tiles_and_batches_agree():
    """Row chunks of 128 and 256 give the same result, and a batch of
    replicas gives what each replica gives alone."""
    system, pos = build_system(chignolin_assembly((2, 1, 1)), gb_model="gbn2",
                               dense_scales=False)
    x = torch.from_numpy(_noisy(pos.numpy(), 3, seed=2))
    e128, f128 = build_pair_force_fn(system, tile=128)(x)
    e256, f256 = build_pair_force_fn(system, tile=256)(x)
    torch.testing.assert_close(e128, e256, rtol=1e-6, atol=0)
    torch.testing.assert_close(f128, f256, rtol=0, atol=1e-6 * float(f128.abs().max()))
    fn = build_pair_force_fn(system)
    for r in range(3):
        e1, f1 = fn(x[r])
        assert e1.shape == () and f1.shape == x[r].shape
        torch.testing.assert_close(e1, e128[r], rtol=1e-6, atol=0)
        torch.testing.assert_close(f1, f128[r], rtol=0, atol=1e-6 * float(f128.abs().max()))


@pytest.mark.parametrize("width", [None, 8], ids=["D24", "D8_far_pairs"])
def test_banded_scales_equal_jax(width):
    """``exclusion_band_width`` and ``banded_scales`` give JAX's arrays
    exactly; a forced band of 8 sends scaled pairs to the far list."""
    from pmarlo_tpu.md.cells import banded_scales as jax_banded_scales
    from pmarlo_tpu.md.cells import exclusion_band_width as jax_width

    js, _ = _jax_system("chignolin_276")
    ts = system_from_numpy(js.to_dict())
    D = jax_width(js) if width is None else width
    assert exclusion_band_width(ts) == jax_width(js) == 24
    ours = banded_scales(ts, D)
    theirs = jax_banded_scales(js, D)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    if width == 8:
        assert ours[2].shape[0] > 0
        band = ExclusionBand.from_numpy(D, *theirs)
        assert band.far_idx.shape == ours[2].shape


def test_forced_narrow_band_matches_jax_energy():
    """D = 8 leaves scaled pairs beyond the band: the far-pair correction
    brings the port's energy and forces back onto the D = 24 result and
    onto JAX's."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.cells import banded_scales as jax_banded_scales
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system("chignolin_138")
    ts = system_from_numpy(js.to_dict())
    x = torch.from_numpy(_noisy(jx, 1, seed=3)[0])
    narrow = ExclusionBand.from_numpy(8, *jax_banded_scales(js, 8))
    en, fn_ = build_pair_force_fn(ts, band=narrow)(x)
    ew, fw = build_pair_force_fn(ts)(x)
    je, jf = jax_pair(js, tile=128, interpret=True)(jnp.asarray(x.numpy()))
    assert abs(float(en) - float(ew)) <= 1e-5 * abs(float(ew))
    assert float((fn_ - fw).abs().max()) <= 1e-4 * float(fw.abs().max())
    assert abs(float(en) - float(je)) <= 1e-5 * abs(float(je))


def test_dense_scales_repair_matches_jax():
    """``dense_scales`` as in JAX: the default builds the (N, N) tables up
    to 12,000 atoms; ``False`` builds none, and the rest is unchanged."""
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine

    dense, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    sparse, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2",
                             dense_scales=False)
    jsparse, _ = jax_build_system(jax_alanine(), gb_model="gbn2", dense_scales=False)
    assert dense.scale_elec is not None and dense.gb_neck_d0 is not None
    for s in (sparse, system_from_numpy(jsparse.to_dict())):
        assert s.scale_elec is None and s.scale_lj is None
        assert s.gb_neck_d0 is None and s.gb_neck_m0 is None
    ours, theirs = sparse.to_dict(), jsparse.to_dict()
    for k, v in theirs.items():
        if isinstance(v, np.ndarray) or hasattr(v, "shape"):
            np.testing.assert_allclose(ours[k], np.asarray(v), rtol=1e-6, atol=0, err_msg=k)


def test_protein_scale_assembly_builds_without_dense_tables():
    """The 3,726-atom chignolin assembly with ``dense_scales=False``: no
    (N, N) table, a band of 24 and no far pairs."""
    system, pos = build_system(chignolin_assembly((3, 3, 3)), gb_model="gbn2",
                               dense_scales=False)
    assert system.n_atoms == 3726 and pos.shape == (3726, 3)
    assert system.scale_elec is None and system.gb_neck_d0 is None
    fn = build_pair_force_fn(system)
    assert fn.band_D == 24 and fn.band.far_idx.shape == (0, 2)


def test_cpu_tensors_never_launch_and_cuda_paths_raise():
    """On the CPU every sweep runs its twin and nothing is launched; the
    launch path refuses CPU tensors instead of falling back."""
    system, pos = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    fn = build_pair_force_fn(system)
    x = torch.from_numpy(_noisy(pos.numpy(), 2))
    before = dict(pair_force.launches)
    I = fn.born(x)
    torch.testing.assert_close(I, fn.born_reference(x), rtol=0, atol=0)
    B, dB = fn.born_radii(I)
    e, d = fn.energy_rows(x, B)
    assert torch.equal(e, fn.energy_rows_reference(x, B)[0])
    c = torch.ones_like(B)
    assert torch.equal(fn.pair_forces(x, B, c), fn.pair_forces_reference(x, B, c))
    ea, fa = fn(x)
    eb, fb = fn.reference(x)
    assert torch.equal(ea, eb) and torch.equal(fa, fb)
    assert pair_force.launches == before
    for args in (("born", x), ("energy", x, B), ("force", x, B, c)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn._launch(*args)
    with pytest.raises(ValueError, match="does not match"):
        fn._launch("force", x, B, c[:, :5])


def test_unported_options_raise():
    """What the pair path refuses: a system with a box, which is explicit
    solvent and has no GB term to compute (``build_system`` turns implicit
    solvent off for it), as the site refusal does for virtual sites. The
    tile-culled, Newton and bonded-kernel arguments are ported
    (``test_torch_pair_culled.py``, ``test_torch_bonded_kernel.py``)."""
    import dataclasses

    system, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    boxed = dataclasses.replace(system, box=(3.0, 3.0, 3.0))
    with pytest.raises(ValueError, match="implicit-solvent path and takes no box"):
        build_pair_force_fn(boxed)
    for kwargs in (dict(gb_cutoff=2.0), dict(gb_cutoff=2.0, order_from=np.zeros((22, 3))),
                   dict(newton=True), dict(bonded="window")):
        assert build_pair_force_fn(system, **kwargs) is not None


def test_failed_build_raises_instead_of_falling_back(monkeypatch):
    """A CUDA tensor never reaches a twin: when the kernel library cannot
    be built the launch raises."""
    from pmarlo_tpu_torch import _kernels

    system, pos = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    fn = build_pair_force_fn(system)

    def broken():
        raise RuntimeError("nvcc failed: injected")

    monkeypatch.setattr(_kernels, "library", broken)
    monkeypatch.setattr(pair_force, "_configured", False)
    fake = pos[None].clone()
    monkeypatch.setattr(fn, "_check_cuda", lambda *a: None)
    with pytest.raises(RuntimeError, match="injected"):
        fn._launch("born", fake)


@pytest.mark.gpu
@pytest.mark.parametrize("copies", [(2, 1, 1), (3, 3, 3)], ids=["276_atoms", "3726_atoms"])
def test_kernels_match_plain_twins_on_the_card(copies):
    """Each sweep kernel against its twin on the same card tensors (R = 8):
    I and dE/dB to 1e-5 of their max, e_rows to 1e-5, forces to 1e-4 of
    max |F|, and the whole evaluation's energy to 1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    system, pos = build_system(chignolin_assembly(copies), gb_model="gbn2",
                               device="cuda", dense_scales=False)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), 8, seed=4, sigma=0.005),
                        device="cuda")
    fn = build_pair_force_fn(system)
    before = dict(pair_force.launches)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    Ip = fn.born_reference(x)
    assert rel(fn.born(x), Ip) <= 1e-5
    B, dB = fn.born_radii(Ip)
    ek, dk = fn.energy_rows(x, B)
    ep, dp = fn.energy_rows_reference(x, B)
    assert rel(ek, ep) <= 1e-5 and rel(dk, dp) <= 1e-5
    _, c = fn.gb_terms(B, dB, dp)
    assert rel(fn.pair_forces(x, B, c), fn.pair_forces_reference(x, B, c)) <= 1e-4
    e, f = fn(x)
    er, fr = fn.reference(x)
    torch.cuda.synchronize()
    assert rel(e, er) <= 1e-5 and rel(f, fr) <= 1e-4
    assert bool(torch.isfinite(f).all())
    assert {k: v - before[k] for k, v in pair_force.launches.items() if v != before[k]} == {
        "pair_born": 2, "pair_energy": 2, "pair_force": 2}
