"""The two redesigned kernels of ``pmarlo_tpu_torch``: the bonded kernel
(``csrc/bonded.cu``), which takes each term once and writes every role's
gradient to the incidence's slot in the per-atom CSR (``bonded_slots``), then
adds each atom's slots in CSR order; and the ordered culled force kernel
(``csrc/pair_force.cu pair_force_culled_kernel``), which walks, a warp a
32-atom row group and a segment of its column groups, the 32 x 32 patches of
the tiles that ``close`` keeps whose group boxes are within the cutoff, and
adds per-segment slots in a fixed order.

On the CPU: the slot map against the CSR, plain PyTorch versions of both
decompositions (used by these tests only, never on the main path) against
the plain versions of ``md/analytic.py`` and ``md/pair_force.py`` and against
the JAX package's windowed bonded kernel in interpret mode, and the walk's
skips against brute force. On the card (``gpu``-marked; they skip here):
each kernel against its plain version at R = 1 and 3, and two launches
bitwise equal:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_bonded_culled_redesign.py``.

Tolerances: the decompositions against the plain versions compute the same
float32 terms and add them in another order: energy to 1e-6 relative,
gradient and forces to 1e-5 of their max. Against JAX (arccos as a
polynomial) and the kernels on the card (the card's special functions),
the gates of ``test_torch_bonded_kernel.py`` and ``test_torch_pair_culled.py``:
energy 1e-5 relative, gradient 1e-4 of max.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure, replicate_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly, chignolin_structure
from pmarlo_tpu_torch.md import bonded_window, pair_force
from pmarlo_tpu_torch.md.analytic import (
    angle_terms,
    bond_terms,
    bonded_energy_and_forces,
    torsion_terms,
)
from pmarlo_tpu_torch.md.bonded_window import bonded_csr, bonded_slots, build_bonded_window
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.pair_force import (
    CULLED_SEGMENTS,
    _morton_order,
    _r2,
    build_pair_force_fn,
    culled_force_scratch,
    cutoff_pairs,
    tile_boxes,
    tiles_within,
)
from pmarlo_tpu_torch.md.system import system_from_numpy


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _alanines(n, spacing):
    return replicate_structure(alanine_dipeptide_structure(), n=n, spacing=spacing)


STRUCTURES = {
    "alanine_22": lambda: alanine_dipeptide_structure(),
    "assembly_88": lambda: _alanines((2, 2, 1), (1.1, 1.1, 1.1)),
    "chignolin_276": lambda: chignolin_assembly((2, 1, 1)),
}


def _noisy(x, R, seed=0, sigma=0.01):
    rng = np.random.default_rng(seed)
    return (np.asarray(x)[None] + rng.normal(0.0, sigma, (R,) + tuple(np.shape(x)))
            ).astype(np.float32)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _tables(system):
    return [t.numpy() for t in (system.bond_idx, system.angle_idx, system.torsion_idx)]


def _incidences(system):
    """Atom, code ``type << 2 | role`` and term of each (term, role)
    incidence, type-major, then term, then role: the order of ``bonded_slots``."""
    atoms, codes, terms = [], [], []
    for ttype, idx in enumerate(_tables(system)):
        for term, members in enumerate(idx):
            for role, atom in enumerate(members):
                atoms.append(int(atom))
                codes.append(ttype << 2 | role)
                terms.append(term)
    return np.array(atoms), np.array(codes), np.array(terms)


# --- the bonded kernel: slots ----------------------------------------------------------


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_slot_map_is_a_bijection_into_the_csr(name):
    """``bonded_slots`` maps the M incidences one to one onto 0..M-1, and
    each (term, role) slot lies in its atom's CSR range, at the entry that
    names the same type, role and term; its ``ptr`` is ``bonded_csr``'s."""
    system, _ = build_system(STRUCTURES[name](), gb_model="gbn2", device="cpu")
    ptr_of_slots, slot = bonded_slots(*_tables(system), system.n_atoms)
    ptr, ent = bonded_csr(*_tables(system), system.n_atoms)
    assert np.array_equal(ptr_of_slots, ptr)
    atoms, codes, terms = _incidences(system)
    M = atoms.shape[0]
    assert slot.dtype == np.int32 and slot.shape == (M,) and ent.shape == (M, 2)
    assert np.array_equal(np.sort(slot), np.arange(M))
    assert np.all(ptr[atoms] <= slot) and np.all(slot < ptr[atoms + 1])
    assert np.array_equal(ent[slot], np.stack([codes, terms], 1))


def two_pass(kernel, x):
    """Plain version of ``csrc/bonded.cu``: the term pass (each term once,
    role k's gradient to slot ``bonded_slots(...)[1][incidence]``, the terms'
    energies summed in float64) and the atom pass (each atom's CSR range of
    slots added in CSR order)."""
    R, n = x.shape[0], x.shape[1]
    p = kernel.params
    energy = torch.zeros(R, dtype=torch.float64)
    shares = []
    for terms in (bond_terms, angle_terms, torsion_terms):
        e, role_forces = terms(p, x)
        energy = energy + e.double().sum(-1)
        shares.append(-torch.stack(role_forces, -2).reshape(R, -1, 3))
    ptr, slot_of = (torch.as_tensor(a, dtype=torch.long)
                    for a in bonded_slots(*_tables(kernel.system), n))
    slots = torch.full((R, slot_of.numel(), 3), float("nan"))
    slots[:, slot_of] = torch.cat(shares, 1)
    degree = ptr[1:] - ptr[:-1]
    grad = torch.zeros_like(x)
    for k in range(int(degree.max())):
        has = degree > k
        grad[:, has] += slots[:, ptr[:-1][has] + k]
    return energy, grad


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_two_passes_equal_the_plain_version(name):
    """The slots added in CSR order equal ``bonded_energy_and_forces``
    (R = 3, distorted): energy to 1e-6 relative, gradient to 1e-5 of max."""
    system, pos = build_system(STRUCTURES[name](), gb_model="gbn2", device="cpu")
    x = torch.from_numpy(_noisy(pos.numpy(), 3, seed=4, sigma=0.02))
    fn = build_bonded_window(system)
    e, g = two_pass(fn, x)
    ep, fp = bonded_energy_and_forces(fn.params, x, energy_dtype=torch.float64)
    assert float((e - ep).abs().max() / ep.abs().max()) <= 1e-6
    assert _rel(g, -fp) <= 1e-5
    assert float(g.abs().max()) > 1e2


@pytest.mark.parametrize("reps,distort", [((1, 1, 1), 0.0), ((2, 2, 1), 0.02)],
                         ids=["22_atoms", "88_atoms_distorted"])
def test_two_passes_match_jax_window_kernel(reps, distort):
    """The same decomposition against JAX's windowed Pallas bonded kernel in
    interpret mode, on the same arrays: energy to 1e-5 relative, gradient to
    1e-4 of max (JAX's arccos is a polynomial)."""
    import jax.numpy as jnp
    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
    from pmarlo_tpu.data import replicate_structure as jax_replicate
    from pmarlo_tpu.md.bonded_window import build_bonded_window as jax_window
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    js, jx = jax_build_system(jax_replicate(jax_alanine(), n=reps, spacing=(1.1, 1.1, 1.1)),
                              gb_model="gbn2")
    x = np.array(jx, np.float32)
    if distort:
        x = (x + distort * np.random.default_rng(5).standard_normal(x.shape)).astype(np.float32)
    je, jg = jax_window(js, stride=128, interpret=True)(jnp.asarray(x))
    fn = build_bonded_window(system_from_numpy(js.to_dict()))
    e, g = two_pass(fn, torch.from_numpy(x)[None])
    je = float(np.asarray(je, np.float64))
    assert abs(float(e[0]) - je) <= 1e-5 * abs(je)
    jg = torch.from_numpy(np.array(jg, np.float32))
    assert _rel(g[0], jg) <= 1e-4


# --- the culled force kernel: the walk -------------------------------------------------


def culled_walk(fn, xs, close):
    """The work of ``pair_force_culled_kernel`` at the stored positions ``xs
    (R, N, 3)``: for each item (rep, row group g, segment s), the column
    groups h = s, s + CULLED_SEGMENTS, ... in increasing order, split into
    those it walks (tile kept by ``close``, group boxes within the cutoff:
    ``tiles_within`` at 32-atom tiles) and those it skips. Returns ``{(rep,
    g, s): (walked, skipped)}``."""
    R, n = xs.shape[:2]
    NG = -(-n // 32)
    near = tiles_within(*tile_boxes(xs, 32), fn.gb_cutoff)
    per_tile = fn.tile // 32
    items = {}
    for rep in range(R):
        for g in range(NG):
            for s in range(CULLED_SEGMENTS):
                walked, skipped = [], []
                for h in range(s, NG, CULLED_SEGMENTS):
                    take = bool(close[rep, g // per_tile, h // per_tile]) and bool(near[rep, g, h])
                    (walked if take else skipped).append(h)
                items[rep, g, s] = walked, skipped
    return items


def near_rows(fn, xs, rep, g, h):
    """``(rows,)`` bool: the atoms of row group g within the cutoff of column
    group h's box, the rows the kernel tests against the columns."""
    lo, hi = tile_boxes(xs[rep:rep + 1], 32)
    x = xs[rep, g * 32:g * 32 + 32]
    gap = torch.maximum(lo[0, h] - x, x - hi[0, h]).clamp_min(0.0)
    return cutoff_pairs(gap, fn.gb_cutoff)


def walk_forces(fn, xs, B, c, close):
    """Plain version of ``pair_force_culled_kernel``: each item's walked
    patches in order, the pairs inside the cutoff of their near rows (the
    coincident ones left out), the row atom's share -W d summed into the
    item's slot; an atom's CULLED_SEGMENTS slots added in slot order."""
    R, n = xs.shape[:2]
    slots = torch.zeros((R, CULLED_SEGMENTS, n, 3), dtype=xs.dtype)
    idx = torch.arange(n)
    for (rep, g, seg), (walked, _) in culled_walk(fn, xs, close).items():
        s, e = g * 32, min(g * 32 + 32, n)
        x = xs[rep:rep + 1]
        for h in walked:
            cols = idx[h * 32:h * 32 + 32]
            d = x[:, s:e, None, :] - x[:, None, cols, :]
            r2 = _r2(d)
            pair = ((r2 > 1e-8) & cutoff_pairs(d, fn.gb_cutoff)
                    & near_rows(fn, xs, rep, g, h)[None, :, None])
            r = torch.where(pair, torch.sqrt(r2 + 1e-12), torch.ones_like(r2))
            Wd = fn.pair_force_terms(B[rep:rep + 1], c[rep:rep + 1], s, e, cols, d, r,
                                     pair.to(xs.dtype))
            slots[rep, seg, s:e] -= Wd[0].sum(1)
    out = torch.zeros_like(xs)
    for seg in range(CULLED_SEGMENTS):
        out = out + slots[:, seg]
    return out


def _geometry(name):
    """Stored positions ``(2, N, 3)`` of a geometry, with its pair force
    (tile 128, Morton order) and cutoff."""
    if name == "two_clusters":
        # two chignolins 8 nm apart: one 32-atom group holds atoms of both
        structure, cutoff = replicate_structure(chignolin_structure(), n=(2, 1, 1), gap=8.0), 1.0
    elif name == "spread_line":
        structure, cutoff = _alanines((120, 1, 1), (6.0, 0.0, 0.0)), 1.5
    else:
        structure, cutoff = chignolin_assembly((2, 1, 1)), 1.5
    system, pos = build_system(structure, gb_model="gbn2", device="cpu", dense_scales=False)
    fn = build_pair_force_fn(system, tile=128, gb_cutoff=cutoff, order_from=pos, newton=False)
    x = torch.from_numpy(_noisy(pos.numpy(), 2, seed=6, sigma=0.01))
    return fn, fn.to_storage(x)


@pytest.mark.parametrize("name", ["two_clusters", "spread_line", "chignolin_276"])
def test_walk_skips_no_pair_inside_the_cutoff(name):
    """Every ordered patch (g, h) belongs to exactly one item; no column
    group an item skips, and no row of a walked patch beyond the cutoff of
    the column group's box, holds an ordered pair that ``cutoff_pairs``
    keeps; the walk skips some patches."""
    fn, xs = _geometry(name)
    n = xs.shape[1]
    NG = -(-n // 32)
    close = fn.close_tiles(xs)
    items = culled_walk(fn, xs, close)
    n_skipped = far = 0
    for rep in range(2):
        pairs = cutoff_pairs(xs[rep, :, None, :] - xs[rep, None, :, :], fn.gb_cutoff)
        pairs &= ~torch.eye(n, dtype=torch.bool)
        for g in range(NG):
            owned = sorted(h for s in range(CULLED_SEGMENTS) for h in sum(items[rep, g, s], []))
            assert owned == list(range(NG))
            for s in range(CULLED_SEGMENTS):
                walked, skipped = items[rep, g, s]
                assert walked == sorted(walked)
                block = pairs[g * 32:g * 32 + 32]
                for h in skipped:
                    assert not bool(block[:, h * 32:h * 32 + 32].any())
                for h in walked:
                    rows = near_rows(fn, xs, rep, g, h)
                    assert not bool(block[~rows, h * 32:h * 32 + 32].any())
                    far += int((~rows).sum())
                n_skipped += len(skipped)
    assert n_skipped > 0 and far > 0


@pytest.mark.parametrize("name", ["two_clusters", "chignolin_276"])
def test_walk_forces_equal_the_plain_version(name):
    """The walk's forces, summed by segment slots, equal the ordered plain
    version ``pair_forces_reference`` to 1e-5 of max |F| (R = 2)."""
    fn, xs = _geometry(name)
    close = fn.close_tiles(xs)
    B, dB = fn.born_radii(fn.born_reference(xs, close))
    _, dEdB = fn.energy_rows_reference(xs, B, close)
    _, c = fn.gb_terms(B, dB, dEdB)
    F = walk_forces(fn, xs, B, c, close)
    F_ref = fn.pair_forces_reference(xs, B, c, close)
    assert _rel(F, F_ref) <= 1e-5
    assert float(F_ref.abs().max()) > 1e2


def test_culled_force_scratch_size():
    """The culled force kernel's scratch: the 32-atom groups' boxes, then
    the per-segment slots, float32 entries."""
    assert CULLED_SEGMENTS == 4
    assert culled_force_scratch(1, 61_824) == 1_932 * 6 + 4 * 61_824 * 3
    assert culled_force_scratch(3, 33) == 3 * (2 * 6 + 4 * 33 * 3)


def test_morton_walk_on_a_random_cloud_skips_patches():
    """The walk on a 4 nm cloud of 333 points in Morton order (three tiles
    of 128, ragged): items cover every ordered patch, and their skipped
    patches hold no pair inside the cutoff."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 4.0, (2, 333, 3))
    xs = torch.as_tensor(np.stack([xr[_morton_order(xr)] for xr in x]), dtype=torch.float32)
    system, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")
    fn = build_pair_force_fn(system, tile=128, gb_cutoff=0.9)
    close = tiles_within(*tile_boxes(xs, 128), 0.9)
    pairs = cutoff_pairs(xs[:, :, None, :] - xs[:, None, :, :], 0.9)
    skipped = 0
    for (rep, g, s), (walked, skip) in culled_walk(fn, xs, close).items():
        assert sorted(walked + skip) == list(range(s, 11, CULLED_SEGMENTS))
        for h in skip:
            assert not bool(pairs[rep, g * 32:g * 32 + 32, h * 32:h * 32 + 32].any())
        skipped += len(skip)
    assert skipped > 0


# --- on the card -----------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 3])
def test_bonded_kernel_matches_plain_version_on_the_card(R):
    """The two-pass bonded kernel against ``bonded_energy_and_forces`` on
    the same card tensors (3,726 atoms, distorted): energy to 1e-5
    relative, gradient to 1e-4 of max; one launch a call, the same bits
    from a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    system, pos = build_system(chignolin_assembly((3, 3, 3)), gb_model="gbn2", device="cuda",
                               dense_scales=False)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), R, seed=7, sigma=0.01), device="cuda")
    fn = build_bonded_window(system)
    before = bonded_window.launches["bonded"]
    e, g = fn(x, energy_dtype=torch.float64)
    e2, g2 = fn(x, energy_dtype=torch.float64)
    torch.cuda.synchronize()
    assert bonded_window.launches["bonded"] == before + 2
    assert torch.equal(e, e2) and torch.equal(g, g2)
    ep, gp = fn.reference(x, energy_dtype=torch.float64)
    assert float((e - ep).abs().max() / ep.abs().max()) <= 1e-5
    assert _rel(g, gp) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 3])
def test_culled_force_kernel_matches_plain_version_on_the_card(R):
    """The ordered culled force kernel against ``pair_forces_reference``
    (3,726 atoms, tile 128, cutoff 1.5 nm, Morton order): forces to 1e-4 of
    max |F|; one launch a call, the same bits from a second launch; at 276
    atoms against the walk's plain version too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for copies in ((3, 3, 3), (2, 1, 1)):
        system, pos = build_system(chignolin_assembly(copies), gb_model="gbn2", device="cuda",
                                   dense_scales=False)
        x = torch.as_tensor(_noisy(pos.cpu().numpy(), R, seed=8, sigma=0.005), device="cuda")
        fn = build_pair_force_fn(system, tile=128, gb_cutoff=1.5, order_from=pos, newton=False)
        xs = fn.to_storage(x)
        close = fn.close_tiles(xs)
        B, dB = fn.born_radii(fn.born_reference(xs, close))
        _, dEdB = fn.energy_rows_reference(xs, B, close)
        _, c = fn.gb_terms(B, dB, dEdB)
        before = pair_force.launches["pair_force_culled"]
        F = fn.pair_forces(xs, B, c, close)
        F2 = fn.pair_forces(xs, B, c, close)
        torch.cuda.synchronize()
        assert pair_force.launches["pair_force_culled"] == before + 2
        assert torch.equal(F, F2)
        assert _rel(F, fn.pair_forces_reference(xs, B, c, close)) <= 1e-4
        if copies == (2, 1, 1):
            cpu = [t.cpu() for t in (xs, B, c, close)]
            fc = build_pair_force_fn(system.to("cpu"), tile=128, gb_cutoff=1.5,
                                     order_from=pos.cpu(), newton=False)
            assert _rel(F.cpu(), walk_forces(fc, *cpu)) <= 1e-4
