"""The two redesigned GB force kernels of ``pmarlo_tpu_torch``: the dense
``pair_force_kernel`` (``csrc/pair_force.cu``), which takes each unordered
pair once in (row tile, column tile >= row tile) blocks and adds per-slot
partials in a fixed order, and the Newton ``newton_force_kernel``
(``csrc/pair_newton.cu``), which walks a block list, skips 32 x 32 patches
whose 32-atom group boxes are out of range and evaluates only the pairs
inside the cutoff.

On the CPU: plain PyTorch versions of both decompositions (used by these
tests only, never on the main path) against the plain versions of
``md/pair_force.py`` and against the JAX package's Pallas pair sweeps in
interpret mode, and the patch skip against brute force. On the card
(``gpu``-marked; they skip here): the dense kernel's two launches bitwise
equal, the Newton kernel against the ordered culled kernel and run to run:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_pair_force_redesign.py``.

Tolerances: forces to 1e-4 of max |F| and energies to 1e-5 relative, the
float32 rounding of sums taken in another order.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure, replicate_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly, chignolin_structure
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.pair_force import (
    FORCE_TILE,
    _morton_order,
    _r2,
    build_pair_force_fn,
    cutoff_pairs,
    tile_boxes,
    tiles_within,
)
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


def _noisy(x, R, seed=0, sigma=0.01):
    rng = np.random.default_rng(seed)
    return (np.asarray(x)[None] + rng.normal(0.0, sigma, (R,) + tuple(np.shape(x)))
            ).astype(np.float32)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _chain_inputs(fn, xs):
    """Born radii and chain coefficients of the stored positions ``xs``, as
    the evaluation hands them to the force sweep."""
    B, dB = fn.born_radii(fn.born_reference(xs))
    _, dEdB = fn.energy_rows_reference(xs, B)
    _, c = fn.gb_terms(B, dB, dEdB)
    return B, c


# --- plain versions of the two decompositions ----------------------------------------


def block_forces(fn, x, B, c):
    """Plain version of ``pair_force_kernel``: one block a (row tile r,
    column tile c >= r) of ``FORCE_TILE`` atoms, each unordered pair once
    (a diagonal block: column > row); the block's sums go to the slot of the
    partner tile (row atoms to slot c, column atoms to slot r), each slot is
    written once, and an atom's G slots are added in slot order."""
    R, n = x.shape[:2]
    T = FORCE_TILE
    G = -(-n // T)
    slots = torch.full((R, G, n, 3), float("nan"), dtype=x.dtype, device=x.device)
    idx = torch.arange(n, device=x.device)
    for ct in range(G):
        cols = idx[ct * T:(ct + 1) * T]
        for rt in range(ct + 1):
            s, e = rt * T, min((rt + 1) * T, n)
            d = x[:, s:e, None, :] - x[:, None, cols, :]
            r2 = _r2(d)
            pair = r2 > 1e-8
            if rt == ct:
                pair = pair & (cols[None, :] > idx[s:e, None])
            r = torch.where(pair, torch.sqrt(r2 + 1e-12), torch.ones_like(r2))
            Wd = fn.pair_force_terms(B, c, s, e, cols, d, r, pair.to(x.dtype))
            rows_part, cols_part = -Wd.sum(2), Wd.sum(1)
            if rt == ct:
                slots[:, rt, s:e] = rows_part + cols_part
            else:
                slots[:, ct, s:e] = rows_part
                slots[:, rt, cols] = cols_part
    assert not bool(slots.isnan().any()), "a slot was left unwritten"
    out = torch.zeros_like(x)
    for slot in range(G):
        out = out + slots[:, slot]
    return out


def newton_blocks(close):
    """The blocks (rep, r, c >= r) that ``close (R, G, G)`` keeps, whose
    32 x 32 patches the Newton kernels' patch list draws from."""
    rep, r, c = torch.nonzero(torch.triu(close), as_tuple=True)
    return list(zip(rep.tolist(), r.tolist(), c.tolist()))


def patch_walk(fn, xs, close):
    """The work list of the Newton force kernel, and the patches it leaves
    out: of the 32 x 32 patches (rep, g, h >= g) of 32-atom groups whose
    tile block ``close`` keeps, those whose two group boxes are within the
    cutoff (``tiles_within`` at 32-atom tiles). Returns ``(kept, skipped)``,
    lists of (rep, row group, column group)."""
    near = tiles_within(*tile_boxes(xs, 32), fn.gb_cutoff)
    per_tile = fn.tile // 32
    kept, skipped = [], []
    for rep, r, c in newton_blocks(close):
        for g in range(r * per_tile, min((r + 1) * per_tile, near.shape[1])):
            for h in range(max(g, c * per_tile), min((c + 1) * per_tile, near.shape[1])):
                (kept if bool(near[rep, g, h]) else skipped).append((rep, g, h))
    return kept, skipped


def near_rows(fn, xs, rep, g, h):
    """``(32,)`` bool: the atoms of row group g within the cutoff of column
    group h's box, the rows the kernel tests against the 32 columns (gap of
    an atom to the box, tested as ``tiles_within`` tests two boxes)."""
    lo, hi = tile_boxes(xs[rep:rep + 1], 32)
    x = xs[rep, g * 32:g * 32 + 32]
    gap = torch.maximum(lo[0, h] - x, x - hi[0, h]).clamp_min(0.0)
    rows = cutoff_pairs(gap, fn.gb_cutoff)
    return torch.nn.functional.pad(rows, (0, 32 - rows.numel()))


def patch_forces(fn, xs, B, c, close):
    """Plain version of ``newton_force_kernel``: in each listed patch, the
    pairs inside the cutoff of its near rows, each once, -W d to the row
    atom and +W d to the column atom."""
    n = xs.shape[1]
    out = torch.zeros_like(xs)
    idx = torch.arange(n, device=xs.device)
    kept, _ = patch_walk(fn, xs, close)
    for rep, g, h in kept:
        rows = idx[g * 32:g * 32 + 32][near_rows(fn, xs, rep, g, h)[:min(32, n - g * 32)]]
        cols = idx[h * 32:h * 32 + 32]
        x = xs[rep:rep + 1]
        d = x[:, rows, None, :] - x[:, None, cols, :]
        r2 = _r2(d)
        pair = (r2 > 1e-8) & cutoff_pairs(d, fn.gb_cutoff) & (cols[None, :] > rows[:, None])
        r = torch.where(pair, torch.sqrt(r2 + 1e-12), torch.ones_like(r2))
        for k, i in enumerate(rows.tolist()):
            Wd = fn.pair_force_terms(B[rep:rep + 1], c[rep:rep + 1], i, i + 1, cols, d[:, k:k + 1],
                                     r[:, k:k + 1], pair[:, k:k + 1].to(xs.dtype))[0, 0]
            out[rep, i] -= Wd.sum(0)
            out[rep].index_add_(0, cols, Wd)
    return out


# --- the dense decomposition ---------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    """The port's dense pair force, stored positions (R = 2), Born radii and
    chain coefficients by structure name."""
    cache = {}

    def get(name):
        if name not in cache:
            system, pos = build_system(STRUCTURES[name](), gb_model="gbn2", device="cpu",
                                       dense_scales=False)
            fn = build_pair_force_fn(system)
            x = torch.from_numpy(_noisy(pos.numpy(), 2, seed=11))
            cache[name] = (fn, x, *_chain_inputs(fn, x))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_block_decomposition_matches_plain_forces(dense, name):
    """Blocks, slots and the slot sum give the row-owned plain version's
    forces (22 atoms: one diagonal block; 276 atoms: three tiles, the last
    ragged)."""
    fn, x, B, c = dense(name)
    F = block_forces(fn, x, B, c)
    Fp = fn.pair_forces_reference(x, B, c)
    assert _rel(F, Fp) <= 1e-4


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_block_decomposition_is_bitwise_reproducible(dense, name):
    """Every sum of the decomposition has a fixed order: two runs give the
    same bits, as two launches of the kernel must."""
    fn, x, B, c = dense(name)
    assert torch.equal(block_forces(fn, x, B, c), block_forces(fn, x, B, c))


def _jax_system(name):
    """The JAX package's system and positions for a structure of
    ``STRUCTURES``."""
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s = STRUCTURES[name]()
    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    return jax_build_system(PDBStructure(residues=residues), gb_model="gbn2")


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_block_decomposition_matches_jax_force_sweep(name):
    """The whole evaluation with the block decomposition as its force sweep
    against ``pallas_pair.build_pair_force_fn(tile=128, interpret=True)``,
    whose forces come from the Pallas ``sweep3``."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system(name)
    fn = build_pair_force_fn(system_from_numpy(js.to_dict()))
    x = _noisy(jx, 1, seed=12)[0]
    je, jf = jax_pair(js, tile=128, interpret=True)(jnp.asarray(x))
    te, tf = fn._evaluate(torch.from_numpy(x), fn.born_reference, fn.energy_rows_reference,
                          lambda xs, B, c, close: block_forces(fn, xs, B, c),
                          fn.bonded_reference)
    je, jf = float(je), np.asarray(jf)
    assert abs(float(te) - je) <= 1e-5 * abs(je)
    assert np.abs(tf.numpy() - jf).max() <= 1e-4 * np.abs(jf).max()


# --- the Newton walk -----------------------------------------------------------------


@pytest.mark.parametrize("geometry", ["random", "collapsed", "line"])
def test_skipped_patches_hold_no_pair_within_the_cutoff(geometry):
    """In the blocks ``close`` keeps (tiles of 128, ragged last tile, batch
    of two), no patch the force kernel's list leaves out, and no row of a
    listed patch beyond the cutoff of the column group's box, holds a pair
    that ``cutoff_pairs`` keeps; the listed and left-out patches together
    are the blocks' patches on or above the diagonal."""
    rng = np.random.default_rng(3)
    n, cutoff = 333, 0.9
    x = rng.uniform(0.0, 4.0, (2, n, 3))
    if geometry == "random":
        x = np.stack([xr[_morton_order(xr)] for xr in x])
    elif geometry == "collapsed":
        x *= 0.05
    elif geometry == "line":
        x[..., 1:] *= 0.01
        x = np.sort(x, axis=1)
    x = torch.as_tensor(x, dtype=torch.float32)
    system, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")
    fn = build_pair_force_fn(system, tile=128, gb_cutoff=cutoff)
    close = tiles_within(*tile_boxes(x, 128), cutoff)
    kept, skipped = patch_walk(fn, x, close)
    pairs = cutoff_pairs(x[:, :, None, :] - x[:, None, :, :], cutoff)
    for rep, g, h in skipped:
        assert not bool(pairs[rep, g * 32:g * 32 + 32, h * 32:h * 32 + 32].any())
    far_rows = 0
    for rep, g, h in kept:
        far = ~near_rows(fn, x, rep, g, h)[:min(32, n - g * 32)]
        assert not bool(pairs[rep, g * 32:g * 32 + 32, h * 32:h * 32 + 32][far].any())
        far_rows += int(far.sum())
    blocks = newton_blocks(close)
    sizes = [-(-min(128, n - t * 128) // 32) for t in range(3)]
    expected = sum(sizes[r] * (sizes[r] + 1) // 2 if r == c else sizes[r] * sizes[c]
                   for _, r, c in blocks)
    assert len(kept) + len(skipped) == expected
    if geometry == "collapsed":
        assert not skipped and far_rows == 0
    else:
        assert skipped and kept and far_rows


@pytest.mark.parametrize("name,cutoff", [("assembly_132", 1.0), ("chignolin_276", 1.5)])
def test_patch_walk_forces_match_newton_plain_forces(name, cutoff):
    """The forces of the kept patches' pairs (the kernel's walk) equal the
    Newton and the ordered plain versions' on a batch in Morton order."""
    structures = {
        "assembly_132": lambda: replicate_structure(alanine_dipeptide_structure(),
                                                    n=(3, 2, 1), spacing=(1.1, 1.1, 1.1)),
        "chignolin_276": lambda: chignolin_assembly((2, 1, 1)),
    }
    system, pos = build_system(structures[name](), gb_model="gbn2", device="cpu",
                               dense_scales=False)
    x = torch.from_numpy(_noisy(pos.numpy(), 2, seed=13))
    kw = dict(tile=128, gb_cutoff=cutoff, order_from=pos)
    fn = build_pair_force_fn(system, newton=True, **kw)
    fo = build_pair_force_fn(system, newton=False, **kw)
    xs = fn.to_storage(x)
    close = fn.close_tiles(xs)
    B, c = _chain_inputs(fo, xs)
    F = patch_forces(fn, xs, B, c, close)
    assert _rel(F, fn.pair_forces_reference(xs, B, c, close)) <= 1e-4
    assert _rel(F, fo.pair_forces_reference(xs, B, c, close)) <= 1e-4
    _, skipped = patch_walk(fn, xs, close)
    if name == "chignolin_276":
        assert skipped


# --- on the card ---------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("copies", [(2, 1, 1), (3, 3, 3)], ids=["276_atoms", "3726_atoms"])
def test_dense_force_kernel_is_bitwise_reproducible_on_the_card(copies):
    """Two launches of the dense force kernel give the same bits (R = 8),
    and agree with the plain version and the block decomposition to 1e-4
    of max |F|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    system, pos = build_system(chignolin_assembly(copies), gb_model="gbn2",
                               device="cuda", dense_scales=False)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), 8, seed=14, sigma=0.005), device="cuda")
    fn = build_pair_force_fn(system)
    B, c = _chain_inputs(fn, x)
    F1 = fn.pair_forces(x, B, c)
    F2 = fn.pair_forces(x, B, c)
    torch.cuda.synchronize()
    assert torch.equal(F1, F2)
    assert _rel(F1, fn.pair_forces_reference(x, B, c)) <= 1e-4
    if copies == (2, 1, 1):
        assert _rel(F1, block_forces(fn, x, B, c)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("copies,cutoff", [((2, 1, 1), 1.0), ((3, 3, 3), 1.5)],
                         ids=["276_atoms", "3726_atoms"])
def test_newton_force_kernel_matches_ordered_kernel_on_the_card(copies, cutoff):
    """The Newton force kernel against the ordered culled force kernel on
    the same inputs (R = 3, tile 128, Morton order) to 1e-4 of max |F|, and
    against itself run to run (its sums are atomic) at the same gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    system, pos = build_system(chignolin_assembly(copies), gb_model="gbn2",
                               device="cuda", dense_scales=False)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), 3, seed=15, sigma=0.005), device="cuda")
    kw = dict(tile=128, gb_cutoff=cutoff, order_from=pos)
    fn = build_pair_force_fn(system, newton=True, **kw)
    fo = build_pair_force_fn(system, newton=False, **kw)
    xs = fn.to_storage(x)
    close = fn.close_tiles(xs)
    B, c = _chain_inputs(fo, xs)
    Fn = fn.pair_forces(xs, B, c, close)
    Fn2 = fn.pair_forces(xs, B, c, close)
    Fo = fo.pair_forces(xs, B, c, close)
    torch.cuda.synchronize()
    assert _rel(Fn, Fo) <= 1e-4
    assert _rel(Fn2, Fn) <= 1e-4
    assert _rel(Fn, fn.pair_forces_reference(xs, B, c, close)) <= 1e-4
