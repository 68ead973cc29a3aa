"""The explicit-solvent sweeps of ``pmarlo_tpu_torch`` (``csrc/cell_force.cu``
``cell_force_kernel``, ``csrc/periodic_force.cu`` ``periodic_force_kernel``),
which take each unordered pair inside the cutoff once, on full warps.

On the CPU: plain versions of the two walks (used by these tests only, never
on the main path) that enumerate exactly the kernels' decomposition:

- ``walk_cells``: the half shell, a work item (cell, direction, split of
  its row groups) of the own cell (column after row in sorted order) and the
  13 forward neighbours with their lattice shifts, its 32 x 32 patches,
  every pair displaced once from the item's side, sums to 56 slots an atom,
  each written by one item, added in slot order;
- ``walk_blocks``: the dense (row tile, column tile >= row tile) blocks of
  128 atoms, their patches (column > row on a diagonal patch), the per-axis
  minimum image, sums to one slot a block and atom, added in slot order.

They are held against brute force as the same set of unordered image pairs
(a count and the pairs, on grids with 1, 2 and 3 cells an axis, a sheared box
and a cell of 375 atoms), against the ordered plain versions (the dense
sweep's own, and the 27-cell walk that the cell sweep's plain version took
before it took the half shell) and against the JAX package's Pallas sweeps in
interpret mode in reaction-field, switched and Ewald mode; the cell sweep's
plain version cuts the same pairs as the walk, also a pair whose two
orientations round to opposite sides of the cutoff. On the card
(``gpu``-marked; they skip here): both kernels against their plain versions
at R = 1, 4, 8, two launches bitwise equal, the 1- and 2-cell grids and the
scratch refusal:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_explicit_sweeps_redesign.py``.

Tolerances: energies to 1e-5 relative, forces to 1e-4 of max |F| (PERF.md
section 2's explicit gate: sums taken in another order, JAX's float32 pair
terms and its polynomial erfc), energy rows to 1e-5 of their max.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.io.pdb import read_pdb
from pmarlo_tpu_torch.md import cell_force, periodic_force
from pmarlo_tpu_torch.md.cell_force import (
    CELL_SLOTS,
    CELL_SPLITS,
    HALF_SHELL,
    CellForce,
    build_cell_force_fn,
    cell_scratch,
)
from pmarlo_tpu_torch.md.cells import bin_atoms
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.periodic_force import (
    PERIODIC_TILE,
    build_periodic_force_fn,
    cutoff_mask,
    pair_terms,
    periodic_scratch,
    refuse_scratch,
)
from pmarlo_tpu_torch.md.system import system_from_numpy

SHEAR = (0.12, 0.12, 0.12)
EWALD_TOL = 5e-4


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _noisy(x, R, seed, sigma=0.02):
    rng = np.random.default_rng(seed)
    return (np.asarray(x)[None] + rng.normal(0.0, sigma, (R,) + tuple(np.shape(x)))
            ).astype(np.float32)


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


def _assert_close(e, f, e_ref, f_ref, what):
    assert _rel(e, e_ref) <= 1e-5, what
    assert _rel(f, f_ref) <= 1e-4, what


def _water(cutoff, tilt=None, switch=None, side=5, device="cpu"):
    s, box = water_box_structure(side)
    return build_system(s, box=box, tilt=tilt, cutoff=cutoff, switch_distance=switch,
                        hydrogen_mass=None, device=device)


def _cells(system, dims=None, **kw):
    """The cell force of ``system``; ``dims`` replaces the grid's cell counts
    (fewer, thicker cells: the 27-cell neighbourhood still covers the
    cutoff)."""
    fn = build_cell_force_fn(system, **kw)
    if dims is None:
        return fn
    grid = dataclasses.replace(fn.grid, nx=dims[0], ny=dims[1], nz=dims[2])
    return CellForce(system, grid, fn.phys, band=fn.band)


def _binned(fn, x):
    order, cell_start, _, xw = bin_atoms(fn.grid, torch.as_tensor(x))
    return xw, order.contiguous(), cell_start.contiguous()


def _pair_values(fn, ai, aj, d):
    """float64 pair terms of the float32 displacements ``d`` of the pairs
    (ai, aj): (half energy, W d)."""
    q, sig, seps = (row.double() for row in fn._atom_p)
    d = d.double()
    e_lj, e_el, w_lj, w_el, inv_r = pair_terms(
        fn.phys, (d * d).sum(-1), q[ai] * q[aj], 0.5 * (sig[ai] + sig[aj]),
        seps[ai] * seps[aj])
    return 0.5 * (e_lj + e_el), ((w_lj + w_el) * inv_r)[..., None] * d


def _sum_slots(slots, order=None):
    """Each atom's slots (R, S, N, 4: force, energy half-sum) added in slot
    order (a slot left unwritten fails): ``(e_rows, forces)`` by atom
    index."""
    assert not bool(slots.isnan().any()), "a slot was left unwritten"
    total = torch.zeros_like(slots[:, 0])
    for s in range(slots.shape[1]):
        total = total + slots[:, s]
    if order is not None:
        by_atom = torch.empty_like(total)
        for r in range(total.shape[0]):
            by_atom[r, order[r].long()] = total[r]
        total = by_atom
    return total[..., 3], total[..., :3].float()


def _write(slots, rep, s, pos, v):
    assert bool(slots[rep, s, pos].isnan().all()), "a slot was written twice"
    slots[rep, s, pos] = v


def _wrap_vector(code):
    code = int(code)
    return (code // 9 - 1, (code // 3) % 3 - 1, code % 3 - 1)


def _key(a, b, w):
    """The unordered image pair of row a and column b displaced by lattice
    vector w: (lower index, higher index, image of the lower's partner)."""
    a, b = int(a), int(b)
    return (a, b) + tuple(w) if a < b else (b, a) + tuple(-v for v in w)


# --- plain versions of the kernels' walks --------------------------------------------


def walk_cells(fn, xw, order, cell_start):
    """Plain version of ``cell_force_kernel``: items (replica, cell, k, s)
    for k in ``HALF_SHELL`` and split s < ``CELL_SPLITS`` (the cell's row
    groups s, s + ``CELL_SPLITS``, ...); each item's 32 x 32
    patches (the own cell: column group >= row group, a diagonal patch
    column > row) with the column atoms displaced by the lattice shift of
    offset k; by sorted position, the rows' sums to the row slot of
    direction d = k - 13, every column atom's sums (a zero where it has no
    pair) to the split's column slot of d; slots added in slot order.
    Returns ``(e_rows, forces, pairs)``, ``pairs`` a list (one a replica) of
    the unordered image pairs taken."""
    R, n = xw.shape[:2]
    S = CELL_SPLITS
    slots = torch.full((R, CELL_SLOTS, n, 4), float("nan"), dtype=torch.float64)
    pairs = []
    for rep in range(R):
        x, cs, ordr = xw[rep], cell_start[rep].long(), order[rep].long()
        taken = []
        for cell, k in itertools.product(range(fn.grid.n_cells), HALF_SHELL):
            d_item = k - 13
            nb, wrap = int(fn._nb[k, cell]), int(fn._wrap[k, cell])
            shift = fn._shifts[wrap]
            r0, r1, c0, c1 = int(cs[cell]), int(cs[cell + 1]), int(cs[nb]), int(cs[nb + 1])
            rows, cols = ordr[r0:r1], ordr[c0:c1]
            n_groups = -(-(r1 - r0) // 32)
            for split in range(S):
                col = torch.zeros((c1 - c0, 4), dtype=torch.float64)
                for g0 in (32 * g for g in range(split, n_groups, S)):
                    row = torch.zeros((min(32, r1 - r0 - g0), 4), dtype=torch.float64)
                    for h0 in range(g0 if d_item == 0 else 0, c1 - c0, 32):
                        ai, aj = rows[g0:g0 + 32], cols[h0:h0 + 32]
                        d = x[ai][:, None, :] - (x[aj] + shift)[None, :, :]
                        keep = (((ai[:, None] - aj[None, :]).abs() > fn.band_D)
                                & cutoff_mask(d, fn.phys.rc))
                        if d_item == 0 and h0 == g0:
                            keep = keep & torch.ones_like(keep).triu(1)
                        r, c = keep.nonzero(as_tuple=True)
                        half, wd = _pair_values(fn, ai[r], aj[c], d[r, c])
                        row.index_add_(0, r, torch.cat([-wd, half[:, None]], 1))
                        col.index_add_(0, h0 + c, torch.cat([wd, half[:, None]], 1))
                        w = _wrap_vector(wrap)
                        taken += [_key(a, b, w) for a, b in zip(ai[r].tolist(), aj[c].tolist())]
                    _write(slots, rep, d_item * (1 + S), torch.arange(r0 + g0, r0 + g0 + len(row)),
                           row)
                _write(slots, rep, d_item * (1 + S) + 1 + split, torch.arange(c0, c1), col)
        pairs.append(taken)
    e_rows, forces = _sum_slots(slots, order)
    return e_rows, forces, pairs


def _min_image(system, d):
    box = torch.as_tensor(system.box, dtype=torch.float32)
    return d - box * torch.round(d * (1.0 / box))


def walk_blocks(fn, x):
    """Plain version of ``periodic_force_kernel``: blocks (row tile rt,
    column tile ct >= rt) of ``PERIODIC_TILE`` atoms, their 32 x 32 patches
    (a diagonal block: column group >= row group, a diagonal patch column >
    row), the per-axis minimum image in float32; the row atoms' sums to slot
    ct, the column atoms' to slot rt (a diagonal block: both to slot rt);
    slots added in slot order. Returns ``(e_rows, forces, pairs)``."""
    R, n = x.shape[:2]
    T, G = PERIODIC_TILE, -(-n // PERIODIC_TILE)
    slots = torch.full((R, G, n, 4), float("nan"), dtype=torch.float64)
    pairs = []
    for rep in range(R):
        taken = []
        for ct in range(G):
            for rt in range(ct + 1):
                rows = torch.arange(rt * T, min((rt + 1) * T, n))
                cols = torch.arange(ct * T, min((ct + 1) * T, n))
                row = torch.zeros((len(rows), 4), dtype=torch.float64)
                col = torch.zeros((len(cols), 4), dtype=torch.float64)
                for g0 in range(0, len(rows), 32):
                    for h0 in range(g0 if rt == ct else 0, len(cols), 32):
                        ai, aj = rows[g0:g0 + 32], cols[h0:h0 + 32]
                        d = _min_image(fn.system, x[rep, ai][:, None] - x[rep, aj][None])
                        keep = (((ai[:, None] - aj[None, :]).abs() > fn.band_D)
                                & cutoff_mask(d, fn.phys.rc))
                        if rt == ct and g0 == h0:
                            keep = keep & torch.ones_like(keep).triu(1)
                        r, c = keep.nonzero(as_tuple=True)
                        half, wd = _pair_values(fn, ai[r], aj[c], d[r, c])
                        row.index_add_(0, g0 + r, torch.cat([-wd, half[:, None]], 1))
                        col.index_add_(0, h0 + c, torch.cat([wd, half[:, None]], 1))
                        taken += list(zip(ai[r].tolist(), aj[c].tolist()))
                if rt == ct:
                    _write(slots, rep, rt, rows, row + col)
                else:
                    _write(slots, rep, ct, rows, row)
                    _write(slots, rep, rt, cols, col)
        pairs.append(taken)
    e_rows, forces = _sum_slots(slots)
    return e_rows, forces, pairs


def ordered_cells(fn, xw, order, cell_start):
    """The 27-cell walk the cell sweep's plain version took before it took
    the half shell: every atom against the atoms of its 27 neighbour cells,
    each ordered pair displaced from the row's side, half the pair energy
    to the row."""
    R, n = xw.shape[:2]
    e_rows = torch.zeros((R, n), dtype=torch.float64)
    forces = torch.zeros((R, n, 3), dtype=torch.float64)
    for rep in range(R):
        x, cs, ordr = xw[rep], cell_start[rep].long(), order[rep].long()
        for cell, k in itertools.product(range(fn.grid.n_cells), range(27)):
            nb, wrap = int(fn._nb[k, cell]), int(fn._wrap[k, cell])
            ai, aj = ordr[cs[cell]:cs[cell + 1]], ordr[cs[nb]:cs[nb + 1]]
            d = x[ai][:, None, :] - (x[aj] + fn._shifts[wrap])[None, :, :]
            keep = ((ai[:, None] - aj[None, :]).abs() > fn.band_D) & cutoff_mask(d, fn.phys.rc)
            r, c = keep.nonzero(as_tuple=True)
            half, wd = _pair_values(fn, ai[r], aj[c], d[r, c])
            e_rows[rep].index_add_(0, ai[r], half)
            forces[rep].index_add_(0, ai[r], -wd)
    return e_rows, forces.float()


def brute_force_pairs(fn, xw, images=2, tol=1e-5):
    """Every unordered image pair (i < j, lattice image n of j) of ``xw (N,
    3)`` with |i - j| > band inside the cutoff, in float64: ``(inside,
    on_cutoff)``, the pairs with r^2 < rc^2 (1 - tol) and those within
    ``tol`` rc^2 of the cutoff, where float32 and float64 may decide
    differently."""
    H = torch.as_tensor(fn.grid.matrices()[0], dtype=torch.float64)
    x = xw.double()
    n = x.shape[0]
    i, j = torch.triu_indices(n, n, 1)
    far = (j - i) > fn.band_D
    i, j = i[far], j[far]
    rc2 = fn.phys.rc ** 2
    inside, on_cutoff = set(), set()
    rng = range(-images, images + 1)
    for w in itertools.product(rng, rng, rng):
        d = x[i] - x[j] - torch.as_tensor(w, dtype=torch.float64) @ H
        r2 = (d * d).sum(-1)
        for found, sel in ((inside, r2 < rc2 * (1.0 - tol)),
                           (on_cutoff, (r2 - rc2).abs() <= tol * rc2)):
            found |= {(a, b) + w for a, b in zip(i[sel].tolist(), j[sel].tolist())}
    return inside, on_cutoff


def _assert_same_pairs(walked, inside, on_cutoff):
    """``walked`` takes each pair once, every pair inside, and of the rest only
    pairs on the cutoff: the count of the pairs off the cutoff equals brute
    force's."""
    taken = set(walked)
    assert len(walked) == len(taken), "an image pair was taken twice"
    assert inside <= taken and taken <= inside | on_cutoff
    assert len(taken - on_cutoff) == len(inside)


# --- CPU: the walks against brute force ------------------------------------------------

# (cutoff, tilt, grid dims replacing the builder's or None, the grid's dims):
# 3 cells an axis of 14 atoms, 2 of 47, one cell of all 375 atoms (12 groups
# of 32), 1 x 2 x 3, and a sheared box
GRIDS = {
    "3x3x3": (0.5, None, None, (3, 3, 3)),
    "2x2x2": (0.6, None, None, (2, 2, 2)),
    "1x1x1_375_atoms": (0.6, None, (1, 1, 1), (1, 1, 1)),
    "1x2x3": (0.5, None, (1, 2, 3), (1, 2, 3)),
    "sheared": (0.45, SHEAR, None, (3, 3, 3)),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_half_shell_takes_each_image_pair_once(name):
    """The walk's pairs are brute force's unordered image pairs inside the
    cutoff, as a count and pair for pair, none twice; the sweep's plain
    version (``CellForce.half_shell``) yields the same pairs. Brute force is
    float64, the walk float32: a pair within 1e-5 of the cutoff may go
    either way here (the test of the orientation below holds the walk and
    the plain version together there)."""
    cutoff, tilt, dims, expect = GRIDS[name]
    system, x0 = _water(cutoff, tilt=tilt)
    fn = _cells(system, dims)
    assert (fn.grid.nx, fn.grid.ny, fn.grid.nz) == expect
    xw, order, cell_start = _binned(fn, _noisy(x0.numpy(), 1, seed=21))
    _, _, (walked,) = walk_cells(fn, xw, order, cell_start)
    _assert_same_pairs(walked, *brute_force_pairs(fn, xw[0]))
    plain = [_key(a, b, _wrap_vector(fn._wrap[k, c]))
             for ai, aj, _, _, _, cells, k in fn.half_shell(xw[0], order[0], cell_start[0])
             for a, b, c in zip(ai.tolist(), aj.tolist(), cells.tolist())]
    assert len(plain) == len(walked) and set(plain) == set(walked)


def test_dense_blocks_take_each_pair_once():
    """The dense blocks of a 375-atom box (3 tiles, the last one ragged)
    take brute force's unordered minimum-image pairs once each."""
    system, x0 = _water(0.6)
    fn = build_periodic_force_fn(system)
    assert -(-system.n_atoms // PERIODIC_TILE) == 3 and system.n_atoms % PERIODIC_TILE
    x = torch.tensor(_noisy(x0.numpy(), 1, seed=22))
    _, _, (walked,) = walk_blocks(fn, x)
    grid = _cells(system)
    assert grid.phys.rc == fn.phys.rc and grid.band_D == fn.band_D
    inside, on_cutoff = brute_force_pairs(grid, x[0], images=1)
    # the box is over two cutoffs wide: the image inside is the minimum image
    _assert_same_pairs(walked, *({p[:2] for p in found} for found in (inside, on_cutoff)))


# --- CPU: the walks against the ordered plain versions and JAX -------------------------


@pytest.mark.parametrize("mode", ["rf", "switched", "sheared", "ewald"])
def test_cell_walk_matches_ordered_plain_version(mode):
    """The half-shell walk against the 27-cell ordered walk and the sweep's
    plain version (both copies of a noisy 375-atom box): energy rows, sums
    and forces."""
    tilt = SHEAR if mode == "sheared" else None
    cutoff = 0.45 if mode == "sheared" else 0.5
    system, x0 = _water(cutoff, tilt=tilt, switch=0.4 if mode == "switched" else None)
    kw = {}
    if mode == "ewald":
        kw = dict(electrostatics="pme", ewald_tolerance=EWALD_TOL)
    fn = _cells(system, **kw)
    xw, order, cell_start = _binned(fn, _noisy(x0.numpy(), 2, seed=23))
    e_walk, f_walk, _ = walk_cells(fn, xw, order, cell_start)
    e_ord, f_ord = ordered_cells(fn, xw, order, cell_start)
    e_ref, f_ref = fn.sweep_reference(xw, order, cell_start)
    for e, f, what in ((e_ord, f_ord, "ordered walk"), (e_ref, f_ref, "plain version")):
        assert _rel(e_walk, e) <= 1e-5, what
        _assert_close(e_walk.sum(-1), f_walk, e.sum(-1), f, what)


@pytest.mark.parametrize("switch", [None, 0.5], ids=["shifted", "switched"])
def test_dense_walk_matches_ordered_plain_version(switch):
    system, x0 = _water(0.6, switch=switch)
    fn = build_periodic_force_fn(system)
    x = torch.tensor(_noisy(x0.numpy(), 2, seed=24))
    e_walk, f_walk, _ = walk_blocks(fn, x)
    e_ref, f_ref = fn.sweep_reference(x)
    assert _rel(e_walk, e_ref) <= 1e-5
    _assert_close(e_walk.sum(-1), f_walk, e_ref.sum(-1), f_ref, "ordered plain version")


def _jax_water(cutoff, switch=None, tilt=None):
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s, box = water_box_structure(5)
    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    return jax_build_system(PDBStructure(residues=residues, box=s.box), box=box, tilt=tilt,
                            cutoff=cutoff, switch_distance=switch, hydrogen_mass=None)


@pytest.mark.parametrize("mode", ["rf", "switched", "ewald"])
def test_cell_walk_matches_jax_cell_kernel(mode):
    """The whole evaluation with the walk as its sweep against the Pallas
    cell kernel in interpret mode. In Ewald mode both are the full smooth
    PME (``electrostatics="pme"``)."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_cells import build_cell_force_fn as jax_build

    jsys, jx = _jax_water(0.5, switch=0.4 if mode == "switched" else None)
    system = system_from_numpy(jsys.to_dict(), device="cpu")
    xs = torch.tensor(_noisy(jx, 2, seed=25))
    kw = {}
    if mode == "ewald":
        kw = dict(electrostatics="pme", ewald_tolerance=EWALD_TOL)
        jfn = jax_build(jsys, interpret=True, electrostatics="pme", ewald_tolerance=EWALD_TOL)
    else:
        jfn = jax_build(jsys, interpret=True)
    fn = _cells(system, **kw)
    e, f = fn._evaluate(xs, fn.init_state_batched(xs),
                        lambda xw, order, cell_start, shifts: walk_cells(
                            fn, xw, order, cell_start)[:2])
    for r in range(2):
        ek, fk = jfn(jnp.asarray(xs[r].numpy()))
        ek, fk = float(ek), np.asarray(fk)
        _assert_close(e[r], f[r], torch.tensor(ek), torch.tensor(fk), f"Pallas cells, {mode}")


@pytest.mark.parametrize("switch", [None, 0.5], ids=["shifted", "switched"])
def test_dense_walk_matches_jax_periodic_kernel(switch):
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_periodic import build_periodic_force_fn as jax_build

    jsys, jx = _jax_water(0.6, switch=switch)
    system = system_from_numpy(jsys.to_dict(), device="cpu")
    fn = build_periodic_force_fn(system)
    xs = torch.tensor(_noisy(jx, 2, seed=26))
    e, f = fn._evaluate(xs, lambda x: walk_blocks(fn, x)[:2])
    jfn = jax_build(jsys, tile=128, interpret=True)
    for r in range(2):
        ek, fk = jfn(jnp.asarray(xs[r].numpy()))
        _assert_close(e[r], f[r], torch.tensor(float(ek)), torch.tensor(np.asarray(fk)),
                      "Pallas periodic kernel")


# --- CPU: one orientation for the cutoff ------------------------------------------------


def _straddling_pair(L, rc):
    """float32 x coordinates (a, b) of two atoms a cutoff apart across the
    box face, a - (b + L) one way and b - (a - L) the other, whose two r^2
    round to opposite sides of rc^2."""
    f32 = np.float32
    Lf, rc2 = f32(L), f32(rc) * f32(rc)
    a0 = f32(L - 0.05)
    b0 = f32(a0 + f32(rc) - Lf)
    for da, db in itertools.product(range(-64, 65), repeat=2):
        a = f32(a0 + f32(da) * np.spacing(a0))
        b = f32(b0 + f32(db) * np.spacing(b0))
        one, two = f32(a - f32(b + Lf)), f32(b - f32(a - Lf))
        if (f32(one * one) < rc2) != (f32(two * two) < rc2):
            return a, b, bool(f32(one * one) < rc2)
    raise AssertionError("no straddling pair found")


def test_plain_version_takes_one_orientation_on_the_cutoff():
    """Two atoms across the box face, placed so that xi - (xj + L) and
    xj - (xi - L) round to r^2 on opposite sides of the cutoff: the ordered
    27-cell walk counts the pair in one row only (its net force is that
    pair's force); the half-shell walk and the sweep's plain version decide
    it once, from the forward item's side, the same way, and their forces
    add to zero."""
    system, x0 = _water(0.5)
    fn = _cells(system)
    L = float(system.box[0])
    a, b, kept = _straddling_pair(L, fn.phys.rc)
    x = x0.clone()
    i, j = 0, 150                       # two oxygens, far apart in index
    others = torch.cat([x0[:i], x0[i + 1:j], x0[j + 1:]]).double()
    box = torch.as_tensor(system.box, dtype=torch.float64)

    def clearance(yz):
        # the nearest other atom to either new position (minimum image)
        ends = torch.tensor([[a, *yz], [b, *yz]], dtype=torch.float64)
        d = ends[:, None] - others[None]
        d = d - box * torch.round(d / box)
        return float(d.norm(dim=-1).min())

    # the (y, z) of both atoms where they overlap no other atom
    yz = max(itertools.product(np.linspace(0.0, 1.6, 17), repeat=2), key=clearance)
    assert clearance(yz) > 0.1
    x[i] = torch.tensor([a, *yz])
    x[j] = torch.tensor([b, *yz])
    xw, order, cell_start = _binned(fn, x[None].numpy())
    assert torch.equal(xw[0, [i, j]], x[[i, j]])
    e_walk, f_walk, (walked,) = walk_cells(fn, xw, order, cell_start)
    e_ref, f_ref = fn.sweep_reference(xw, order, cell_start)
    plain = {_key(p, q, _wrap_vector(fn._wrap[k, c]))
             for ai, aj, _, _, _, cells, k in fn.half_shell(xw[0], order[0], cell_start[0])
             for p, q, c in zip(ai.tolist(), aj.tolist(), cells.tolist())}
    assert plain == set(walked)
    # a is in the last cell layer, b in the first: the item is a's, whose
    # forward offset (1, 0, 0) reaches b across the face, a - (b + L)
    assert any(set(t[:2]) == {i, j} for t in walked) == kept
    d = torch.tensor([[a - np.float32(b + np.float32(L)), 0.0, 0.0]])
    _, wd = _pair_values(fn, torch.tensor([i]), torch.tensor([j]), d)
    pair_force = float(wd.abs().max())
    assert pair_force > 1.0
    _, f_ord = ordered_cells(fn, xw, order, cell_start)
    assert float(f_ord.double().sum(1).abs().max()) > 0.5 * pair_force
    for f in (f_walk, f_ref):
        assert float(f.double().sum(1).abs().max()) < 0.05 * pair_force
    assert _rel(f_walk, f_ref) <= 1e-5 and _rel(e_walk, e_ref) <= 1e-5


# --- CPU: scratch ------------------------------------------------------------------------


def test_scratch_sizes():
    """The slot scratch of the main paths' shapes: 5.6 MB for the dense
    sweep at R = 8, N = 2,315; 25.8 / 103 MB for the cell sweep on the water
    box at R = 1 / 4, 17.2 MB on solvated chignolin at R = 8."""
    shape, dense = periodic_scratch(8, 2315)
    assert shape == (8, 19, 2315, 4) and dense == 8 * 19 * 2315 * 16
    assert abs(dense / 1e6 - 5.63) < 0.01
    assert CELL_SLOTS == 56 == len(HALF_SHELL) * (1 + CELL_SPLITS)
    for R, n, mb in ((1, 27783, 25.8), (4, 27783, 103.1), (8, 2315, 17.2)):
        shape, need = cell_scratch(R, n)
        assert shape == (R * n * (8 + 4 * CELL_SLOTS),) and need == 4 * shape[0]
        assert need == 928 * R * n and abs(need / 1e6 - mb) < 0.1


# --- the card --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _chignolin(switch=None):
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    st = read_pdb(root / "examples" / "outputs" / "explicit_solvent" / "chignolin_solvated.pdb")
    return build_system(st, box=st.box, cutoff=0.9, switch_distance=switch, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 4, 8])
def test_periodic_kernel_matches_plain_and_reruns_bitwise(R):
    _card()
    system, pos = _chignolin()
    fn = build_periodic_force_fn(system)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), R, seed=R, sigma=0.005), device="cuda")
    before = periodic_force.launches["periodic_force"]
    ek, fk = fn.sweep(x)
    ek2, fk2 = fn.sweep(x)
    ep, fp = fn.sweep_reference(x)
    torch.cuda.synchronize()
    assert periodic_force.launches["periodic_force"] - before == 2
    assert torch.equal(ek, ek2) and torch.equal(fk, fk2)
    assert _rel(ek, ep) <= 1e-5
    _assert_close(ek.sum(-1), fk, ep.sum(-1), fp, "periodic kernel vs plain")


CELL_CARD = {
    "chignolin": lambda: (_chignolin(), None, None),
    "chignolin_switched": lambda: (_chignolin(0.8), None, None),
    "water_2187_ewald": lambda: (_water(0.9, side=9, device="cuda"), None, "pme"),
    "sheared_375": lambda: (_water(0.45, tilt=SHEAR, device="cuda"), None, None),
    "1x1x1_375_atoms": lambda: (_water(0.6, device="cuda"), (1, 1, 1), None),
    "2x2x2": lambda: (_water(0.6, device="cuda"), (2, 2, 2), None),
    "1x2x3": lambda: (_water(0.5, device="cuda"), (1, 2, 3), None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 4, 8])
@pytest.mark.parametrize("name", list(CELL_CARD))
def test_cell_kernel_matches_plain_and_reruns_bitwise(name, R):
    _card()
    (system, pos), dims, electrostatics = CELL_CARD[name]()
    fn = _cells(system, dims, electrostatics=electrostatics or "rf")
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), R, seed=R, sigma=0.01), device="cuda")
    xw, order, cell_start = _binned(fn, x)
    before = cell_force.launches["cell_force"]
    ek, fk = fn.sweep(xw, order, cell_start)
    ek2, fk2 = fn.sweep(xw, order, cell_start)
    ep, fp = fn.sweep_reference(xw, order, cell_start)
    torch.cuda.synchronize()
    assert cell_force.launches["cell_force"] - before == 2
    assert torch.equal(ek, ek2) and torch.equal(fk, fk2)
    assert _rel(ek, ep) <= 1e-5
    _assert_close(ek.sum(-1), fk, ep.sum(-1), fp, f"cell kernel vs plain, {name}")


@pytest.mark.gpu
def test_scratch_refusal_on_the_card(monkeypatch):
    """A shape whose scratch exceeds a quarter of the card's memory is
    refused before anything is allocated or launched."""
    _card()
    system, pos = _water(0.6, device="cuda")
    x = pos[None].contiguous()
    limit = torch.cuda.get_device_properties(x.device).total_memory // 4
    with pytest.raises(ValueError, match="quarter of the card"):
        refuse_scratch("sweep", limit + 1, x.device, 1, 1)
    refuse_scratch("sweep", limit, x.device, 1, 1)
    dense, cells = build_periodic_force_fn(system), _cells(system)
    xw, order, cell_start = _binned(cells, x)
    launched = (periodic_force.launches["periodic_force"], cell_force.launches["cell_force"])
    monkeypatch.setattr(periodic_force, "periodic_scratch",
                        lambda R, n: ((R, 1, n, 4), limit + 1))
    monkeypatch.setattr(cell_force, "cell_scratch", lambda R, n: ((R * n * 232,), limit + 1))
    with pytest.raises(ValueError, match="quarter of the card"):
        dense.sweep(x)
    with pytest.raises(ValueError, match="quarter of the card"):
        cells.sweep(xw, order, cell_start)
    assert launched == (periodic_force.launches["periodic_force"],
                        cell_force.launches["cell_force"])
