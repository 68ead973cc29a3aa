"""The cell-list force path (``pmarlo_tpu_torch/md/cell_force.py``,
``md/cells.py``): the grid and the binning against the JAX package's, the
plain version against the JAX package's Pallas cell kernel (run in
interpret mode on the CPU) in reaction-field, switched and smooth-PME mode,
on an orthorhombic and a sheared water box; the dispersion tail, the
stateful entries, the refusals; and the CUDA kernel against the plain
version on the card, also in its Ewald mode under a box that changes.

JAX is imported inside the tests that compare against it, so that the
``gpu`` tests also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_cell_force.py``.

Tolerances: energies to 1e-5 relative and forces to 1e-4 of max |F| (JAX
sums float32 pair terms in another order, the port's plain version
evaluates them in float64; in Ewald mode the TPU kernel's erfc is a
polynomial approximant 1.5e-7 off ``erfc``, inside the same bounds).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.md import cell_force
from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
from pmarlo_tpu_torch.md.cells import NeighborState, bin_atoms, free_skin, make_cell_grid
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.forces import energy_and_forces_autograd
from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn
from pmarlo_tpu_torch.md.system import system_from_numpy

CUTOFF = 0.5             # a 5^3 box is 1.65 nm wide: three cell layers an axis
SHEAR = (0.12, 0.12, 0.12)


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


def _jax_water(switch=None, tilt=None, cutoff=CUTOFF):
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s, box = water_box_structure(5)
    return jax_build_system(_jax_structure(s), box=box, tilt=tilt, cutoff=cutoff,
                            switch_distance=switch, hydrogen_mass=None)


def _noisy(x, R, seed, sigma=0.02):
    rng = np.random.default_rng(seed)
    return (np.asarray(x)[None] + rng.normal(0.0, sigma, (R,) + tuple(np.shape(x)))
            ).astype(np.float32)


def _assert_close(e, f, e_ref, f_ref, what):
    e, f, e_ref, f_ref = (np.asarray(a, np.float64) for a in (e, f, e_ref, f_ref))
    assert np.abs(e - e_ref).max() <= 1e-5 * np.abs(e_ref).max(), what
    assert np.abs(f - f_ref).max() <= 1e-4 * np.abs(f_ref).max(), what


GRIDS = [
    ((6.61, 6.61, 6.61), None, 0.9, 27783),
    ((3.0018, 2.8549, 2.6764), None, 0.9, 2315),
    ((1.65, 1.65, 1.65), SHEAR, 0.45, 375),
    ((3.2, 3.2, 2.2627), (0.0, 1.6, 1.6), 0.6, 900),
]


@pytest.mark.parametrize("box,tilt,cutoff,n", GRIDS)
def test_grid_and_bins_match_jax(box, tilt, cutoff, n):
    """``make_cell_grid`` counts JAX's cells (its capacity is JAX's
    without the lane alignment), ``free_skin`` agrees, and ``bin_atoms``
    puts every atom in JAX's cell with JAX's wrapped coordinates; the sort
    is by cell, ascending atom index within a cell."""
    import jax.numpy as jnp
    from pmarlo_tpu.md import cells as jcells

    grid = make_cell_grid(box, cutoff, n, tilt=tilt)
    jgrid = jcells.make_cell_grid(box, cutoff, n, tilt=tilt, lane_align=False)
    assert (grid.nx, grid.ny, grid.nz) == (jgrid.nx, jgrid.ny, jgrid.nz)
    assert grid.capacity == jgrid.capacity and grid.n_cells == jgrid.n_cells
    assert grid.cell_size == jgrid.cell_size
    assert free_skin(grid) == jcells.free_skin(jgrid)
    rng = np.random.default_rng(n)
    m = min(n, 3000)
    x = rng.uniform(-1.0, 1.0 + max(box), (2, m, 3)).astype(np.float32)
    order, cell_start, cid, xw = bin_atoms(grid, torch.tensor(x))
    for r in range(2):
        _, jcid, _, jxw = jcells.bin_atoms(jgrid, jnp.asarray(x[r]))
        jcid = np.asarray(jcid)
        # an atom within rounding of a cell face may fall on either side
        same = cid[r].numpy() == jcid
        assert same.mean() > 0.999
        np.testing.assert_allclose(xw[r].numpy()[same], np.asarray(jxw)[same], atol=2e-6)
        o, cs, c = order[r].long().numpy(), cell_start[r].numpy(), cid[r].numpy()
        assert sorted(o) == list(range(m)) and cs[0] == 0 and cs[-1] == m
        for cell in range(grid.n_cells):
            members = o[cs[cell]:cs[cell + 1]]
            assert (c[members] == cell).all() and (np.diff(members) > 0).all()


@pytest.mark.parametrize("mode", ["rf", "switched", "sheared", "ewald"])
def test_water_box_matches_jax_kernel(mode):
    """Plain version on a 375-atom water box (two perturbed copies)
    against the Pallas cell kernel in interpret mode. In Ewald mode both
    are the full smooth PME (``electrostatics="pme"``)."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_cells import build_cell_force_fn as jax_build

    jsys, jx = _jax_water(switch=0.4 if mode == "switched" else None,
                          tilt=SHEAR if mode == "sheared" else None,
                          cutoff=0.45 if mode == "sheared" else CUTOFF)
    system = system_from_numpy(jsys.to_dict())
    assert system.tilt == (SHEAR if mode == "sheared" else None)
    xs = _noisy(jx, 2, seed=11)
    electrostatics = "pme" if mode == "ewald" else "rf"
    jfn = jax_build(jsys, interpret=True, electrostatics=electrostatics)
    fn = build_cell_force_fn(system, electrostatics=electrostatics)
    assert (fn.grid.nx, fn.grid.ny, fn.grid.nz) == (jfn.grid.nx, jfn.grid.ny, jfn.grid.nz)
    assert math.isclose(free_skin(fn.grid), jfn.skin, rel_tol=1e-12)
    assert fn.electrostatics == jfn.electrostatics == electrostatics
    if mode == "ewald":
        assert (fn.pme_order, fn.pme_mesh_shape) == (jfn.pme_order, jfn.pme_mesh_shape)
    e, f = fn(torch.tensor(xs))
    for r in range(2):
        ek, fk = jfn(jnp.asarray(xs[r]))
        ek, fk = float(ek), np.asarray(fk)
        _assert_close(e[r], f[r], ek, fk, f"Pallas cell kernel (interpret), {mode}")
    # one configuration without the batch dimension: the same bits, but for
    # the mesh of PME, whose batched FFT sums in another order
    e1, f1 = fn(torch.tensor(xs[0]))
    assert e1.shape == ()
    if mode == "ewald":
        assert float((f1 - f[0]).abs().max()) <= 1e-6 * float(f[0].abs().max())
        assert abs(float(e1 - e[0])) <= 1e-6 * abs(float(e[0]))
    else:
        assert torch.equal(f1, f[0])


@pytest.mark.parametrize("tilt", [None, SHEAR], ids=["orthorhombic", "sheared"])
def test_cells_match_dense_oracle(tilt):
    """The cell path against autograd of the dense periodic energy
    (float64), the third, independent check; on the orthorhombic box also
    against the dense sweep's plain version: the same physics by two
    routes."""
    s, box = water_box_structure(5)
    cutoff = 0.45 if tilt is not None else CUTOFF
    system, x0 = build_system(s, box=box, tilt=tilt, cutoff=cutoff, hydrogen_mass=None,
                              device="cpu")
    x = torch.tensor(_noisy(x0.numpy(), 2, seed=13))
    e, f = build_cell_force_fn(system)(x)
    eo, fo = energy_and_forces_autograd(system, x.double())
    _assert_close(e, f, eo, fo, "dense autograd oracle")
    if tilt is None:
        ed, fd = build_periodic_force_fn(system)(x)
        _assert_close(e, f, ed, fd, "dense periodic sweep")


def test_dispersion_correction_matches_jax():
    """The tail term 2 pi C / V: the coefficient against JAX's and the
    energy offset of ``dispersion_correction=True`` (forces unchanged)."""
    from pmarlo_tpu.md.dispersion import dispersion_coefficient as jax_coefficient
    from pmarlo_tpu_torch.md.dispersion import dispersion_coefficient

    jsys, jx = _jax_water()
    system = system_from_numpy(jsys.to_dict())
    C = dispersion_coefficient(system)
    assert math.isclose(C, jax_coefficient(jsys), rel_tol=1e-6) and C < 0.0
    x = torch.tensor(_noisy(jx, 1, seed=15))
    e0, f0 = build_cell_force_fn(system)(x)
    fn = build_cell_force_fn(system, dispersion_correction=True)
    e1, f1 = fn(x)
    assert math.isclose(fn.e_dispersion, 2.0 * math.pi * C / float(np.prod(system.box)),
                        rel_tol=1e-12)
    assert torch.equal(f0, f1)
    assert math.isclose(float(e1 - e0), fn.e_dispersion, rel_tol=1e-3)


@pytest.mark.parametrize("entry", ["evaluate", "apply"])
def test_apply_after_motion_equals_fresh_evaluation(entry):
    """``evaluate`` on a kept cell assignment (every atom within half the
    grid's slack of where it was binned, some across the box face, the
    swept coordinates advanced by the raw displacement) gives the fresh
    evaluation's numbers; ``apply`` bins afresh and returns the binning of
    its own positions. Batched and single entries."""
    s, box = water_box_structure(5)
    system, x0 = build_system(s, box=box, cutoff=CUTOFF, hydrogen_mass=None, device="cpu")
    fn = build_cell_force_fn(system)
    skin = free_skin(fn.grid)
    assert skin == pytest.approx(1.65 / 3 - CUTOFF)
    rng = np.random.default_rng(17)
    # the lattice's first layer of atoms sits on the box face
    x = torch.tensor(_noisy(x0.numpy(), 2, seed=17)) - 0.12
    st = fn.init_state_batched(x)
    step = rng.uniform(-1.0, 1.0, x.shape) * (0.45 * skin / math.sqrt(3.0))
    x1 = x + torch.tensor(step, dtype=torch.float32)
    e_new, f_new = fn(x1)
    if entry == "evaluate":
        kept = NeighborState(order=st.order, cell_start=st.cell_start, xw=st.xw + (x1 - x))
        assert bool((kept.xw < 0).any() or (kept.xw > 1.65).any())
        e, f = fn.evaluate(x1, kept)
        _assert_close(e, f, e_new, f_new, "evaluate on the kept assignment")
        return
    e, f, st = fn.apply_batched(x1, st)
    np.testing.assert_array_equal(f.numpy(), f_new.numpy())
    np.testing.assert_array_equal(e.numpy(), e_new.numpy())
    fresh = fn.init_state_batched(x1)
    assert torch.equal(st.order, fresh.order) and torch.equal(st.xw, fresh.xw)
    st1 = fn.init_state(x[0])
    e1, f1, st1 = fn.apply(x1[0], st1)
    assert e1.shape == () and f1.shape == (375, 3)
    e_one, f_one = fn(x1[0])
    _assert_close(e1, f1, e_one, f_one, "single-system apply")


def test_refusals_keep_their_meaning():
    """The 2 x cutoff width refusal, the option that is not ported yet
    (``mesh``), a box tensor of the wrong shape, and a grid with no slack."""
    s, box = water_box_structure(5)
    system, x = build_system(s, box=box, cutoff=CUTOFF, hydrogen_mass=None, device="cpu")
    with pytest.raises(ValueError, match="needs system.box"):
        build_cell_force_fn(dataclasses.replace(system, box=None))
    with pytest.raises(ValueError, match="smaller than 2\\*cutoff"):
        build_cell_force_fn(dataclasses.replace(system, cutoff=0.9))
    with pytest.raises(ValueError, match="pme_mesh_refine"):
        build_cell_force_fn(system, electrostatics="pme", pme_mesh_refine=0.9)
    with pytest.raises(NotImplementedError, match="A13"):
        build_cell_force_fn(system, mesh=object())
    with pytest.raises(ValueError, match="rf\\|pme"):
        build_cell_force_fn(system, electrostatics="ewald")
    npt = build_cell_force_fn(system)
    box = torch.tensor(system.box + (1.0,))
    for entry, args in ((npt.dynamic, (x, box)), (npt.init_state_dynamic, (x, box)),
                        (npt.apply_dynamic, (x, None, box))):
        with pytest.raises(ValueError, match="box must be"):
            entry(*args)
    # no slack between the cell layers and the cutoff: every call bins
    # afresh, so the stateful entries work all the same
    tight = build_cell_force_fn(dataclasses.replace(system, cutoff=0.55))
    assert free_skin(tight.grid) == pytest.approx(0.0, abs=1e-12)
    e, f, _ = tight.apply(x, tight.init_state(x))
    e_ref, f_ref = tight(x)
    assert torch.equal(e, e_ref) and torch.equal(f, f_ref)
    fn = npt
    with pytest.raises(TypeError, match="float32"):
        fn(x.double())
    with pytest.raises(ValueError, match="must be"):
        fn(x[:10])


def _card_system(which):
    from pathlib import Path

    from pmarlo_tpu_torch.io.pdb import read_pdb

    if which.startswith("chignolin"):
        root = Path(__file__).resolve().parents[2]
        st = read_pdb(root / "examples" / "outputs" / "explicit_solvent"
                      / "chignolin_solvated.pdb")
        return build_system(st, box=st.box, cutoff=0.9, device="cuda",
                            switch_distance=0.8 if which.endswith("switched") else None)
    s, box = water_box_structure(5 if which == "sheared_375" else 9)
    if which == "sheared_375":
        return build_system(s, box=box, tilt=SHEAR, cutoff=0.45, hydrogen_mass=None,
                            device="cuda")
    return build_system(s, box=box, cutoff=0.9, hydrogen_mass=None, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["water_2187", "water_2187_ewald", "sheared_375",
                                   "chignolin_2315", "chignolin_switched"])
def test_kernel_matches_plain_version_on_the_card(which):
    """``cell_force_kernel`` against its plain version on the same card
    tensors (R = 4): energy rows and the whole energy to 1e-5, forces to
    1e-4 of max |F|; one launch an evaluation, and ``evaluate`` on a kept
    assignment equals a fresh evaluation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    system, pos = _card_system(which)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), 4, seed=4, sigma=0.01), device="cuda")
    fn = build_cell_force_fn(system, electrostatics="pme" if which.endswith("ewald") else "rf")
    before = cell_force.launches["cell_force"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    order, cell_start, _, xw = bin_atoms(fn.grid, x)
    ek, fk = fn.sweep(xw, order.contiguous(), cell_start.contiguous())
    ep, fp = fn.sweep_reference(xw, order, cell_start)
    assert rel(ek, ep) <= 1e-5 and rel(fk, fp) <= 1e-4
    e, f = fn(x)
    er, fr = fn.reference(x)
    torch.cuda.synchronize()
    assert rel(e, er) <= 1e-5 and rel(f, fr) <= 1e-4
    assert bool(torch.isfinite(f).all())
    assert cell_force.launches["cell_force"] - before == 2
    st = fn.init_state_batched(x)
    x1 = x + 0.2 * free_skin(fn.grid)
    kept = NeighborState(order=st.order, cell_start=st.cell_start, xw=st.xw + (x1 - x))
    e1, f1 = fn.evaluate(x1, kept)
    e2, f2 = fn(x1)
    assert rel(e1, e2) <= 1e-5 and rel(f1, f2) <= 1e-4
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        fn._launch(xw.cpu(), order.cpu(), cell_start.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["water_2187_ewald", "sheared_375"])
def test_kernel_under_a_changed_box_matches_plain_version_on_the_card(which):
    """The NPT path on the card: ``cell_force_kernel`` in its Ewald mode
    with the shifts of a box tensor (molecules scaled rigidly into boxes 2%
    larger and 1.5% smaller) against its plain version, the sweep and the
    whole PME evaluation (``dynamic`` / ``reference``), energy to 1e-5 and
    forces to 1e-4 of max |F|; one launch a sweep and an evaluation; a box
    whose cell layers fall below the cutoff gives NaN, not a fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from pmarlo_tpu_torch.md import barostat

    system, pos = _card_system(which)
    fn = build_cell_force_fn(system, electrostatics="pme")
    ids = barostat.molecule_ids(system)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), 1, seed=8, sigma=0.01)[0], device="cuda")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for s in (1.02, 0.985):
        box = torch.tensor(system.box, dtype=torch.float32, device="cuda") * s
        xs = barostat.scale_positions(x, s, ids, system.masses, int(ids.max()) + 1)
        before = cell_force.launches["cell_force"]
        order, cell_start, _, xw = bin_atoms(fn.grid, xs[None], box)
        shifts = fn.box_shifts(box)
        ek, fk = fn.sweep(xw, order.contiguous(), cell_start.contiguous(), shifts)
        ep, fp = fn.sweep_reference(xw, order, cell_start, shifts)
        assert rel(ek, ep) <= 1e-5 and rel(fk, fp) <= 1e-4
        e, f = fn.dynamic(xs, box)
        er, fr = fn.reference(xs, box)
        torch.cuda.synchronize()
        assert abs(float(e - er)) <= 1e-5 * abs(float(er)) and rel(f, fr) <= 1e-4
        assert bool(torch.isfinite(f).all())
        assert cell_force.launches["cell_force"] - before == 2
    e_bad, f_bad = fn.dynamic(x, torch.tensor(system.box, device="cuda") * 0.5)
    torch.cuda.synchronize()
    assert math.isnan(float(e_bad)) and bool(torch.isnan(f_bad).all())
