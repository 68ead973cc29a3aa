"""The TPU slot-layout helpers of ``md/cells.py`` (``C_FEAT``,
``cell_slots``, ``scatter_features``, ``ghost_pad``,
``make_cell_grid(lane_align=)``, ``CellGrid.n_slots``) against the JAX
package's.

Seeded random atoms in an orthorhombic and a triclinic box, binned by
JAX's ``bin_atoms`` (whose slots the helpers take) and by the port's
``bin_atoms`` + ``cell_slots``, on the static box and under a box tensor. The results are float32 copies and sums of the same
numbers, held equal to 1e-6 nm.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.md import cells

jax = pytest.importorskip("jax")
jnp = jax.numpy

BOX = (3.0, 3.2, 2.9)
TILT = (0.4, -0.3, 0.5)
CUTOFF = 0.9
N_ATOMS = 300


@pytest.mark.parametrize("lane_align", [False, True], ids=["sublane", "lane_align"])
@pytest.mark.parametrize("box,cutoff,n,tilt", [
    (BOX, CUTOFF, N_ATOMS, None), ((6.61, 6.61, 6.61), 0.9, 27_783, None),
    ((2.0, 2.0, 9.0), 1.0, 2_315, None), (BOX, CUTOFF, N_ATOMS, TILT),
], ids=["small", "water_box", "one_cell_axis", "triclinic"])
def test_make_cell_grid_matches_jax(box, cutoff, n, tilt, lane_align):
    from pmarlo_tpu.md.cells import make_cell_grid as jax_grid

    got = cells.make_cell_grid(box, cutoff, n, lane_align=lane_align, tilt=tilt)
    want = jax_grid(box, cutoff, n, lane_align=lane_align, tilt=tilt)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_slots == want.n_slots == got.n_cells * got.capacity
    assert got.capacity % (128 if lane_align else 8) == 0


@pytest.fixture(scope="module", params=["orthorhombic", "triclinic"])
def binned(request):
    """JAX's grid and binning of seeded random atoms, and the port's grid."""
    from pmarlo_tpu.md.cells import bin_atoms, make_cell_grid as jax_grid

    tilt = TILT if request.param == "triclinic" else None
    rng = np.random.default_rng(50)
    x = (rng.uniform(-0.5, 1.5, (N_ATOMS, 3)) * np.asarray(BOX)).astype(np.float32)
    feats = [rng.normal(0.0, 0.5, N_ATOMS).astype(np.float32),
             rng.uniform(0.1, 0.4, N_ATOMS).astype(np.float32),
             rng.uniform(0.0, 1.0, N_ATOMS).astype(np.float32)]
    jgrid = jax_grid(BOX, CUTOFF, N_ATOMS, tilt=tilt)
    slot, _, overflow, xw = bin_atoms(jgrid, jnp.asarray(x))
    assert not bool(overflow)
    grid = cells.make_cell_grid(BOX, CUTOFF, N_ATOMS, tilt=tilt)
    return jgrid, grid, np.array(slot), np.array(xw), feats


def _jax_slots(jgrid, slot, xw, feats):
    from pmarlo_tpu.md.cells import scatter_features as jax_scatter

    return jax_scatter(jgrid, jnp.asarray(xw), jnp.asarray(slot), *map(jnp.asarray, feats))


def test_scatter_features_matches_jax(binned):
    jgrid, grid, slot, xw, feats = binned
    got = cells.scatter_features(grid, torch.from_numpy(xw), torch.from_numpy(slot),
                                 *map(torch.from_numpy, feats))
    want = np.asarray(_jax_slots(jgrid, slot, xw, feats))
    assert cells.C_FEAT == 8
    assert tuple(got.shape) == want.shape == (cells.C_FEAT, grid.n_slots)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # every atom lands once; empty slots are parked and marked
    assert int(got[6].sum()) == N_ATOMS
    empty = got[6] == 0
    assert torch.all(got[7][empty] == -1e6) and torch.all(got[0][empty] == -100.0 * BOX[0])


@pytest.mark.parametrize("box", [None, (3.1, 3.3, 3.05)], ids=["static_box", "box_tensor"])
def test_ghost_pad_matches_jax(binned, box):
    from pmarlo_tpu.md.cells import ghost_pad as jax_pad

    jgrid, grid, slot, xw, feats = binned
    jslots = _jax_slots(jgrid, slot, xw, feats)
    tslots = torch.from_numpy(np.array(jslots))
    want = np.asarray(jax_pad(jgrid, jslots, None if box is None else jnp.asarray(box,
                                                                                 jnp.float32)))
    got = cells.ghost_pad(grid, tslots, None if box is None else torch.tensor(box))
    g = grid
    assert tuple(got.shape) == want.shape == (
        cells.C_FEAT, (g.nx + 2) * (g.ny + 2) * (g.nz + 2) * g.capacity)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(tslots, torch.from_numpy(np.array(jslots)))   # the input stays
    # the interior is the slot array itself
    inner = got.reshape(cells.C_FEAT, g.nx + 2, g.ny + 2, g.nz + 2, g.capacity)[:, 1:-1, 1:-1, 1:-1]
    assert torch.equal(inner.reshape(cells.C_FEAT, -1), tslots)


def test_ghost_pad_wraps_a_one_cell_axis():
    """A grid one cell thick along z pads that axis with the same cell on
    both sides, shifted by -c and +c."""
    from pmarlo_tpu.md.cells import ghost_pad as jax_pad
    from pmarlo_tpu.md.cells import make_cell_grid as jax_grid

    box = (2.0, 2.0, 1.2)
    grid = cells.make_cell_grid(box, 0.9, 40)
    assert grid.nz == 1
    slots = torch.from_numpy(np.random.default_rng(51).uniform(
        0.0, 1.0, (cells.C_FEAT, grid.n_slots)).astype(np.float32))
    got = cells.ghost_pad(grid, slots)
    want = np.asarray(jax_pad(jax_grid(box, 0.9, 40), jnp.asarray(slots.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tilt", [None, TILT], ids=["orthorhombic", "triclinic"])
@pytest.mark.parametrize("n_atoms,capacity", [(N_ATOMS, None), (N_ATOMS, 8)],
                         ids=["fits", "overflow"])
def test_port_binning_feeds_the_slot_helpers_as_jax(tilt, n_atoms, capacity):
    """The port's ``bin_atoms`` -> ``cell_slots`` -> ``scatter_features`` ->
    ``ghost_pad`` against JAX's ``bin_atoms`` -> ``scatter_features`` ->
    ``ghost_pad``: the same slots and overflow flag (also with a capacity
    too small, where ranks clamp), then the same arrays."""
    from pmarlo_tpu.md.cells import bin_atoms as jax_bin
    from pmarlo_tpu.md.cells import ghost_pad as jax_pad
    from pmarlo_tpu.md.cells import make_cell_grid as jax_grid

    rng = np.random.default_rng(52)
    x = (rng.uniform(-0.5, 1.5, (n_atoms, 3)) * np.asarray(BOX)).astype(np.float32)
    feats = [rng.normal(0.0, 0.5, n_atoms).astype(np.float32),
             rng.uniform(0.1, 0.4, n_atoms).astype(np.float32),
             rng.uniform(0.0, 1.0, n_atoms).astype(np.float32)]
    jgrid = jax_grid(BOX, CUTOFF, n_atoms, tilt=tilt)
    grid = cells.make_cell_grid(BOX, CUTOFF, n_atoms, tilt=tilt)
    if capacity is not None:
        jgrid = dataclasses.replace(jgrid, capacity=capacity)
        grid = dataclasses.replace(grid, capacity=capacity)
    jslot, _, joverflow, jxw = jax_bin(jgrid, jnp.asarray(x))
    order, cell_start, cell_id, xw = cells.bin_atoms(grid, torch.from_numpy(x))
    slot, overflow = cells.cell_slots(grid, order, cell_start, cell_id)
    assert slot.dtype == torch.int64 and overflow.dtype == torch.bool
    assert bool(overflow) == bool(joverflow) == (capacity is not None)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(xw.numpy(), np.asarray(jxw), rtol=0, atol=1e-6)
    if capacity is not None:
        return   # clamped atoms share a slot: which one lands there is unspecified
    got = cells.ghost_pad(grid, cells.scatter_features(grid, xw, slot,
                                                       *map(torch.from_numpy, feats)))
    want = jax_pad(jgrid, _jax_slots(jgrid, np.asarray(jslot), np.asarray(jxw), feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_cell_slots_batch_over_replicas():
    """Leading dimensions bin and slot each replica on its own."""
    rng = np.random.default_rng(53)
    x = torch.from_numpy((rng.uniform(0.0, 1.0, (3, N_ATOMS, 3))
                          * np.asarray(BOX)).astype(np.float32))
    grid = cells.make_cell_grid(BOX, CUTOFF, N_ATOMS)
    slot, overflow = cells.cell_slots(grid, *cells.bin_atoms(grid, x)[:3])
    assert tuple(slot.shape) == (3, N_ATOMS) and not bool(overflow)
    for r in range(3):
        one, _ = cells.cell_slots(grid, *cells.bin_atoms(grid, x[r])[:3])
        assert torch.equal(slot[r], one)
        assert len(torch.unique(slot[r])) == N_ATOMS
