"""The redesigned Newton GB Born and energy kernels of ``pmarlo_tpu_torch``
(``csrc/pair_newton.cu`` ``newton_born_kernel``, ``newton_energy_kernel``):
they walk the force kernel's list of 32 x 32 patches (the patches of the
tile blocks ``close`` keeps whose 32-atom group boxes are within the
cutoff), test only the rows near the column group's box, queue the pairs
inside the cutoff and run them on full warps; one list serves the three
sweeps of an evaluation (``PairForce.patch_list``).

On the CPU: plain PyTorch versions of the walk (``patch_born``,
``patch_energy``; used by these tests only, never on the main path) against
the Newton and the ordered plain versions of ``md/pair_force.py``, on Morton
batches, on geometries where the walk skips patches and where it skips
none, and, as the Born and energy sweeps of a whole evaluation, against the
JAX package's Newton Pallas sweeps in interpret mode (their Born integrals
are internal to JAX's evaluation, so JAX's side is held through the energy
and the forces). On the card (``gpu``-marked; they skip here): both kernels
against their plain versions and the ordered kernels, run to run, and with
the list shared or built per sweep:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_newton_born_energy_redesign.py``.

Tolerances: the walk's plain versions against the plain sweeps 1e-6 of the
largest value (float64 sums, only their order differs); the kernels 1e-5
(float32 pair terms with single special-function results, sums in
another order); against JAX energy 1e-5 relative or 1e-3 kJ/mol and forces
1e-4 of max |F|, atoms with a pair within 1e-5 of the cutoff left out of the
force comparison (the force jumps there, and the two packages round r^2
differently).
"""

import numpy as np
import pytest
import torch
from test_torch_pair_force_redesign import near_rows, patch_forces, patch_walk

from pmarlo_tpu_torch.data import alanine_dipeptide_structure, replicate_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
from pmarlo_tpu_torch.md import pair_force
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.pair_force import _r2, build_pair_force_fn, cutoff_pairs
from pmarlo_tpu_torch.md.system import system_from_numpy

STRUCTURES = {
    "assembly_132": lambda: replicate_structure(alanine_dipeptide_structure(),
                                                n=(3, 2, 1), spacing=(1.1, 1.1, 1.1)),
    "chignolin_276": lambda: chignolin_assembly((2, 1, 1)),
}
CUTOFFS = {"assembly_132": 1.0, "chignolin_276": 1.5}


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


# --- plain versions of the walk --------------------------------------------------------


def _patch_pairs(fn, xs, rep, g, h, dtype):
    """The pairs that the kernels evaluate in one listed patch: the rows of
    group g near column group h's box, against the columns of group h,
    inside the cutoff, not coincident, each unordered pair once (a
    diagonal patch: column > row). Returns ``(s, e, cols, r, one)`` for
    rows s:e of replica ``rep`` in the form of ``PairForce._blocks``: the
    distances in ``dtype`` (as the Newton plain versions take them: Born
    float32, energy float64), the mask decided on float32 numbers."""
    n = xs.shape[1]
    s, e = g * 32, min(g * 32 + 32, n)
    cols = torch.arange(h * 32, min(h * 32 + 32, n))
    x = xs[rep:rep + 1]
    d = x[:, s:e, None, :] - x[:, None, cols, :]
    one = (_r2(d) > 1e-8) & (cols[None, :] > torch.arange(s, e)[:, None])
    if fn.gb_cutoff is not None:   # without one, every row is near
        one = one & cutoff_pairs(d, fn.gb_cutoff) & near_rows(fn, xs, rep, g, h)[:e - s, None]
    xd = x.to(dtype)
    r2 = _r2(xd[:, s:e, None, :] - xd[:, None, cols, :])
    r = torch.where(one, torch.sqrt(r2 + 1e-12), torch.ones_like(r2))
    return s, e, cols, r, one.to(dtype)


def _walk(fn, xs, close):
    """The patches of the Newton kernels' list: ``patch_walk``'s kept ones,
    or without a cutoff every patch (rep, g, h >= g) of the upper triangle."""
    if fn.gb_cutoff is not None:
        return patch_walk(fn, xs, close)[0]
    ng = -(-xs.shape[1] // 32)
    return [(rep, g, h) for rep in range(xs.shape[0]) for g in range(ng) for h in range(g, ng)]


def patch_born(fn, xs, close=None):
    """Plain version of ``newton_born_kernel``: in each listed patch, the
    pairs inside the cutoff of its near rows, each once, H_ij / 2 + neck to
    the row atom's I and H_ji / 2 + neck to the column atom's."""
    out = torch.zeros(xs.shape[:2], dtype=torch.float64)
    for rep, g, h in _walk(fn, xs, close):
        s, e, cols, r, one = _patch_pairs(fn, xs, rep, g, h, xs.dtype)
        to_row, to_col = fn.born_pair_terms(s, e, cols, r, one, columns=True)
        out[rep, s:e] += to_row[0].sum(-1, dtype=torch.float64)
        out[rep].index_add_(0, cols, to_col[0].sum(0, dtype=torch.float64))
    return out.to(xs.dtype)


def patch_energy(fn, xs, B, close=None):
    """Plain version of ``newton_energy_kernel``: in each listed patch, the
    pairs inside the cutoff of its near rows, each once, the pair's energy
    (both rows' shares) to the row atom, each atom's own dE/dB to it.
    Returns ``(e_rows float64, dEdB)`` as ``energy_rows_reference`` does."""
    e_out = torch.zeros(xs.shape[:2], dtype=torch.float64)
    b_out = torch.zeros(xs.shape[:2], dtype=torch.float64)
    for rep, g, h in _walk(fn, xs, close):
        s, e, cols, r, one = _patch_pairs(fn, xs, rep, g, h, torch.float64)
        e_pair, db_row, db_col = fn.energy_pair_terms(B[rep:rep + 1], s, e, cols, r, one,
                                                      columns=True)
        e_out[rep, s:e] += 2.0 * e_pair[0].sum(-1)
        if fn.use_gb:
            b_out[rep, s:e] += db_row[0].sum(-1)
            b_out[rep].index_add_(0, cols, db_col[0].sum(0))
    return e_out, b_out.to(xs.dtype)


# --- inputs ----------------------------------------------------------------------------


def _batch(name, R=2, seed=13):
    """The Newton and the ordered pair force of a structure in Morton order,
    a noisy batch of R in storage order, its close table and Born radii."""
    system, pos = build_system(STRUCTURES[name](), gb_model="gbn2", device="cpu",
                               dense_scales=False)
    kw = dict(tile=128, gb_cutoff=CUTOFFS[name], order_from=pos)
    fn = build_pair_force_fn(system, newton=True, **kw)
    fo = build_pair_force_fn(system, newton=False, **kw)
    xs = fn.to_storage(torch.from_numpy(_noisy(pos.numpy(), R, seed=seed)))
    close = fn.close_tiles(xs)
    B = fn.born_radii(fn.born_reference(xs, close))[0]
    return fn, fo, xs, close, B


def _geometry(kind):
    """276 chignolin atoms in storage order on a geometry where the walk
    skips patches (``line``: a 7 nm rod, 0.9 nm cutoff) or skips none
    (``collapsed``: every pair inside the cutoff), two replicas; the
    collapsed batch holds a coincident pair."""
    system, pos = build_system(STRUCTURES["chignolin_276"](), gb_model="gbn2", device="cpu",
                               dense_scales=False)
    n = system.n_atoms
    rng = np.random.default_rng(5)
    if kind == "line":
        x = np.zeros((2, n, 3))
        x[..., 0] = np.sort(rng.uniform(0.0, 7.0, (2, n)), axis=1)
        x[..., 1:] = rng.normal(0.0, 0.05, (2, n, 2))
    else:
        p = pos.numpy() - pos.numpy().mean(0)
        p = p * (0.35 / np.abs(p).max())
        x = p[None] + rng.normal(0.0, 0.005, (2, n, 3))
        x[:, 7] = x[:, 6]
    fn = build_pair_force_fn(system, tile=128, gb_cutoff=0.9 if kind == "line" else 1.5,
                             newton=True)
    xs = torch.as_tensor(x, dtype=torch.float32)
    return fn, xs, fn.close_tiles(xs)


def _assert_walk_matches_newton_plain(fn, xs, close, B):
    I = patch_born(fn, xs, close)
    assert _rel(I, fn.born_reference(xs, close)) <= 1e-6
    e, dEdB = patch_energy(fn, xs, B, close)
    ep, dp = fn.energy_rows_reference(xs, B, close)
    assert (e - ep).abs().max() <= 1e-6 * ep.abs().max()
    if fn.use_gb:
        assert _rel(dEdB, dp) <= 1e-6
    return I, e, dEdB


# --- the walk against the plain sweeps ---------------------------------------------------


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_patch_walk_born_and_energy_match_newton_plain_versions(name):
    """I, the energy rows (row by row: each pair's energy to its row atom)
    and dE/dB of the kernels' walk equal the Newton plain versions' on a
    Morton batch of two (132 and 276 atoms: ragged last groups)."""
    fn, _, xs, close, B = _batch(name)
    _assert_walk_matches_newton_plain(fn, xs, close, B)
    assert patch_walk(fn, xs, close)[1], "the walk skips patches here"


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_patch_walk_born_and_energy_match_ordered_plain_versions(name):
    """The walk against the ordered (row-owned) plain versions: I and dE/dB
    atom by atom, the energy rows' sums (the rows themselves split each
    pair's energy otherwise)."""
    fn, fo, xs, close, B = _batch(name, seed=14)
    I = patch_born(fn, xs, close)
    assert _rel(I, fo.born_reference(xs, close)) <= 1e-6
    e, dEdB = patch_energy(fn, xs, B, close)
    eo, do = fo.energy_rows_reference(xs, B, close)
    assert _rel(e.sum(-1), eo.sum(-1)) <= 1e-6
    assert _rel(dEdB, do) <= 1e-6


@pytest.mark.parametrize("kind", ["line", "collapsed"])
def test_patch_walk_on_geometries_that_skip_patches_or_none(kind):
    """A rod, on which the list leaves most patches out and most rows of a
    listed patch are far from its column group, and a collapsed batch, on
    which every patch is listed and every row is near (with a coincident
    pair, skipped): the walk equals the Newton plain versions."""
    fn, xs, close = _geometry(kind)
    kept, skipped = patch_walk(fn, xs, close)
    n = xs.shape[1]
    far_rows = sum(int((~near_rows(fn, xs, rep, g, h)[:min(32, n - g * 32)]).sum())
                   for rep, g, h in kept)
    if kind == "collapsed":
        assert not skipped and bool(close.all()) and far_rows == 0
    else:
        assert skipped and kept and far_rows
    B = fn.born_radii(fn.born_reference(xs, close))[0]
    _assert_walk_matches_newton_plain(fn, xs, close, B)


def test_patch_walk_without_cutoff_and_without_gb():
    """``newton=True`` without a cutoff lists every patch of the upper
    triangle with every row near; a system without GB has no Born sweep and
    no dE/dB (the energy kernel's ``use_gb`` 0)."""
    system, pos = build_system(STRUCTURES["assembly_132"](), gb_model="gbn2", device="cpu",
                               dense_scales=False)
    fn = build_pair_force_fn(system, tile=128, newton=True)
    xs = torch.from_numpy(_noisy(pos.numpy(), 2, seed=15))
    B = fn.born_radii(fn.born_reference(xs))[0]
    _assert_walk_matches_newton_plain(fn, xs, None, B)
    assert len(_walk(fn, xs, None)) == 2 * 5 * 6 // 2
    vacuum, _ = build_system(STRUCTURES["assembly_132"](), implicit_solvent=False,
                             device="cpu", dense_scales=False)
    fv = build_pair_force_fn(vacuum, tile=128, gb_cutoff=1.0, newton=True)
    assert not fv.use_gb
    close = fv.close_tiles(xs)
    ones = torch.ones(xs.shape[:2])
    e, _ = patch_energy(fv, xs, ones, close)
    ep, _ = fv.energy_rows_reference(xs, ones, close)
    assert (e - ep).abs().max() <= 1e-6 * ep.abs().max()


def _jax_system(name):
    """The JAX package's system and float32 positions for a structure of
    ``STRUCTURES``."""
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s = STRUCTURES[name]()
    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    js, jx = jax_build_system(PDBStructure(residues=residues), gb_model="gbn2")
    return js, np.array(jx, np.float32)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_patch_walk_sweeps_match_jax_newton_path(name):
    """A batch of two evaluated with the walk's plain versions as its Born,
    energy and force sweeps against ``pallas_pair.build_pair_force_fn(
    gb_cutoff=, order_from=, newton=True, interpret=True)``, replica by
    replica: energy to 1e-5, forces to 1e-4 of max |F|."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system(name)
    cutoff = CUTOFFS[name]
    kw = dict(tile=128, gb_cutoff=cutoff, order_from=jx, newton=True)
    fn = build_pair_force_fn(system_from_numpy(js.to_dict()), **kw)
    jfn = jax_pair(js, interpret=True, **kw)
    x = _noisy(jx, 2, seed=16)
    te, tf = fn._evaluate(torch.from_numpy(x),
                          lambda xs, close: patch_born(fn, xs, close),
                          lambda xs, B, close: patch_energy(fn, xs, B, close),
                          lambda xs, B, c, close: patch_forces(fn, xs, B, c, close),
                          fn.bonded_reference)
    for rep in range(2):
        je, jf = jfn(jnp.asarray(x[rep]))
        je, jf = float(je), np.asarray(jf)
        xd = torch.as_tensor(x[rep], dtype=torch.float64)
        r = torch.cdist(xd, xd)
        keep = ~((r - cutoff).abs() <= 1e-5 * cutoff).any(-1).numpy()
        assert (~keep).sum() <= 4
        assert abs(float(te[rep]) - je) <= max(1e-5 * abs(je), 1e-3)
        assert np.abs(tf[rep].numpy()[keep] - jf[keep]).max() <= 1e-4 * np.abs(jf).max()


# --- on the card -------------------------------------------------------------------------


def _card_case(copies, cutoff, R, seed):
    """The Newton pair force of a chignolin assembly on the card, its
    counterpart in ordered sweeps (the culled kernels with a cutoff, the
    dense kernels without), a noisy batch in storage order and Born radii."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    system, pos = build_system(chignolin_assembly(copies), gb_model="gbn2", device="cuda",
                               dense_scales=False)
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), R, seed=seed, sigma=0.005), device="cuda")
    if cutoff is None:
        fn = build_pair_force_fn(system, tile=128, newton=True)
        fo = build_pair_force_fn(system)
    else:
        kw = dict(tile=128, gb_cutoff=cutoff, order_from=pos)
        fn = build_pair_force_fn(system, newton=True, **kw)
        fo = build_pair_force_fn(system, newton=False, **kw)
    xs = fn.to_storage(x)
    close = fn.close_tiles(xs)
    B = fn.born_radii(fn.born_reference(xs, close))[0]
    return fn, fo, xs, close, B


CARD_CASES = [((2, 1, 1), 1.0), ((2, 1, 1), None), ((3, 3, 3), 1.5), ((3, 3, 3), None)]
CARD_IDS = ["276_cut", "276_whole", "3726_cut", "3726_whole"]


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("copies,cutoff", CARD_CASES, ids=CARD_IDS)
def test_newton_born_and_energy_kernels_match_plain_and_ordered_on_the_card(copies, cutoff, R):
    """Both kernels against their plain versions (I, e_rows, dE/dB to 1e-5
    of their max) and against the ordered kernels on the same inputs (I and
    dE/dB atom by atom, the energy rows' sums), one launch each, none of
    the ordered kernels'."""
    fn, fo, xs, close, B = _card_case(copies, cutoff, R, seed=17)
    before = dict(pair_force.launches)
    I = fn.born(xs, close)
    e, dEdB = fn.energy_rows(xs, B, close)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in pair_force.launches.items() if v != before[k]}
    assert delta == {"pair_born_newton": 1, "pair_energy_newton": 1}
    assert _rel(I, fn.born_reference(xs, close)) <= 1e-5
    ep, dp = fn.energy_rows_reference(xs, B, close)
    assert _rel(e, ep) <= 1e-5 and _rel(dEdB, dp) <= 1e-5
    # the same storage order: the culled sweeps share fn's Morton order, and
    # without a cutoff neither has one
    Io = fo.born(xs, close)
    eo, do = fo.energy_rows(xs, B, close)
    torch.cuda.synchronize()
    assert _rel(I, Io) <= 1e-5 and _rel(dEdB, do) <= 1e-5
    assert _rel(e.sum(-1), eo.sum(-1)) <= 1e-5
    assert bool(torch.isfinite(I).all() and torch.isfinite(e).all())


@pytest.mark.gpu
@pytest.mark.parametrize("copies,cutoff", CARD_CASES, ids=CARD_IDS)
def test_newton_born_and_energy_kernels_run_to_run_and_with_a_shared_list(copies, cutoff):
    """Two launches of each kernel agree under phase 15's gates (their sums
    are atomic, so the last bits may differ); a patch list built once and
    handed to the Born, energy and force sweeps, each twice, gives what a
    list built per sweep gives; an evaluation (one list for its three
    sweeps) equals the plain evaluation."""
    fn, _, xs, close, B = _card_case(copies, cutoff, 8, seed=18)
    I1, I2 = fn.born(xs, close), fn.born(xs, close)
    (e1, d1), (e2, d2) = fn.energy_rows(xs, B, close), fn.energy_rows(xs, B, close)
    patches = fn.patch_list(xs, close)
    Is = [fn.born(xs, close, patches=patches) for _ in range(2)]
    es = [fn.energy_rows(xs, B, close, patches=patches) for _ in range(2)]
    _, c = fn.gb_terms(B, fn.born_radii(I1)[1], d1)
    Fs = [fn.pair_forces(xs, B, c, close, patches=patches) for _ in range(2)]
    F = fn.pair_forces(xs, B, c, close)
    x = fn.from_storage(xs)
    E, G = fn(x)
    Ep, Gp = fn.reference(x)
    torch.cuda.synchronize()
    assert _rel(I2, I1) <= 1e-5 and _rel(e2, e1) <= 1e-5 and _rel(d2, d1) <= 1e-5
    for Ik in Is:
        assert _rel(Ik, I1) <= 1e-5
    for ek, dk in es:
        assert _rel(ek, e1) <= 1e-5 and _rel(dk, d1) <= 1e-5
    for Fk in Fs:
        assert _rel(Fk, F) <= 1e-4
    assert _rel(E.double(), Ep.double()) <= 1e-5 and _rel(G, Gp) <= 1e-4
