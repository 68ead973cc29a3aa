"""The redesigned ordered culled GB Born and energy kernels of
``pmarlo_tpu_torch`` (``csrc/pair_force.cu`` ``pair_born_culled_kernel``,
``pair_energy_culled_kernel``): they take the ordered culled force kernel's
walk (``culled_walk``: a warp a 32-atom row group and a segment of its
column groups, the 32 x 32 patches of the tiles ``close`` keeps whose group
boxes are within the cutoff, the rows near the column group's box, the
pairs inside the cutoff on full warps) with the Born and energy pair
functions, each pair's terms to its row atom, and add per-segment float64
slots in slot order.

On the CPU: plain PyTorch versions of the walk (``walk_born``,
``walk_energy``; used by these tests only, never on the main path) against
the ordered plain versions of ``md/pair_force.py``; the pairs they evaluate
against brute force; and, as the sweeps of a whole evaluation with the
force walk of ``test_torch_bonded_culled_redesign.py``, against the JAX
package's ordered culled Pallas sweeps (``newton=False``) in interpret mode.
On the card (``gpu``-marked; they skip here): both kernels against their
plain versions at 276 and 3,726 atoms, R = 1 and 3, one launch a call, two
launches bitwise equal, and at 276 atoms against the walk's plain versions:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_culled_born_energy_redesign.py``.

Tolerances: I and dE/dB to 1e-5 of their max, the energy rows to 1e-5 of
theirs in float64 (the walk's plain versions take the plain versions'
terms in another order; the kernels single special-function results);
against JAX energy 1e-5 relative or 1e-3 kJ/mol and forces 1e-4 of max |F|,
atoms with a pair within 1e-5 of the cutoff left out of the force
comparison (the force jumps there, and the two packages round r^2
differently).
"""

import numpy as np
import pytest
import torch
from test_torch_bonded_culled_redesign import _geometry, culled_walk, near_rows, walk_forces
from test_torch_newton_born_energy_redesign import CUTOFFS, _jax_system

from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
from pmarlo_tpu_torch.md import pair_force
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.pair_force import (
    CULLED_SEGMENTS,
    _r2,
    build_pair_force_fn,
    culled_force_scratch,
    culled_scratch,
    cutoff_pairs,
)
from pmarlo_tpu_torch.md.system import system_from_numpy

GEOMETRIES = ["two_clusters", "spread_line", "chignolin_276"]


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


def walk_patches(fn, xs, close):
    """The patches the culled kernels walk at the stored positions ``xs (R,
    N, 3)``, item by item in their order: ``(rep, seg, s, e, h, pair)`` for
    the rows s:e of row group g = s / 32 and column group h, with ``pair (1,
    e - s, m)`` the ordered pairs the kernels queue (a row near the column
    group's box, inside the cutoff, not coincident)."""
    n = xs.shape[1]
    for (rep, g, seg), (walked, _) in culled_walk(fn, xs, close).items():
        s, e = g * 32, min(g * 32 + 32, n)
        x = xs[rep:rep + 1]
        for h in walked:
            d = x[:, s:e, None, :] - x[:, None, h * 32:h * 32 + 32, :]
            pair = ((_r2(d) > 1e-8) & cutoff_pairs(d, fn.gb_cutoff)
                    & near_rows(fn, xs, rep, g, h)[None, :, None])
            yield rep, seg, s, e, h, pair


def _distances(x, rep, s, e, h, pair):
    """``(cols, r)``: the column atoms of group h and the distances of the
    rows s:e of replica ``rep`` of ``x`` to them, in the type of ``x``, 1
    where ``pair`` is false (as ``PairForce._blocks`` gives them)."""
    cols = torch.arange(h * 32, min(h * 32 + 32, x.shape[1]))
    d = x[rep:rep + 1, s:e, None, :] - x[rep:rep + 1, None, cols, :]
    one = torch.ones(pair.shape, dtype=x.dtype)
    return cols, torch.where(pair, torch.sqrt(_r2(d) + 1e-12), one)


def _slot_order(slots):
    """An atom's CULLED_SEGMENTS slots ``(R, CULLED_SEGMENTS, N, ...)`` added
    in slot order, as ``dense_slots_kernel`` adds them."""
    out = torch.zeros_like(slots[:, 0])
    for seg in range(CULLED_SEGMENTS):
        out = out + slots[:, seg]
    return out


def walk_born(fn, xs, close, visits=None):
    """Plain version of ``pair_born_culled_kernel``: each item's walked
    patches in order, the pairs it queues, the row atom's H_ij / 2 + neck
    summed into the item's float64 slot; an atom's slots added in slot order.
    ``visits (R, N, N)`` int32, when given, counts each pair evaluated."""
    R, n = xs.shape[:2]
    slots = torch.zeros((R, CULLED_SEGMENTS, n), dtype=torch.float64)
    for rep, seg, s, e, h, pair in walk_patches(fn, xs, close):
        cols, r = _distances(xs, rep, s, e, h, pair)
        to_row, _ = fn.born_pair_terms(s, e, cols, r, pair.to(xs.dtype))
        slots[rep, seg, s:e] += to_row[0].sum(-1, dtype=torch.float64)
        if visits is not None:
            visits[rep, s:e, cols] += pair[0].int()
    return _slot_order(slots).to(xs.dtype)


def walk_energy(fn, xs, B, close, visits=None):
    """Plain version of ``pair_energy_culled_kernel``: the same patches and
    pairs, the row atom's energy 0.5 e_nb + e_gb and dE/dB_i (terms in
    float64, as ``energy_rows_reference`` takes them) summed into the item's
    slots; ``(e_rows float64, dEdB)`` from the slots added in slot order."""
    R, n = xs.shape[:2]
    slots = torch.zeros((R, CULLED_SEGMENTS, n, 2), dtype=torch.float64)
    x64 = xs.double()
    for rep, seg, s, e, h, pair in walk_patches(fn, xs, close):
        cols, r = _distances(x64, rep, s, e, h, pair)
        e_pair, db_row, _ = fn.energy_pair_terms(B[rep:rep + 1], s, e, cols, r, pair.double())
        slots[rep, seg, s:e, 0] += e_pair[0].sum(-1)
        if fn.use_gb:
            slots[rep, seg, s:e, 1] += db_row[0].sum(-1)
        if visits is not None:
            visits[rep, s:e, cols] += pair[0].int()
    out = _slot_order(slots)
    return out[..., 0], out[..., 1].to(xs.dtype)


# --- the walk against the plain sweeps ---------------------------------------------------


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("name", GEOMETRIES)
def test_walk_born_and_energy_equal_the_plain_versions(name, R):
    """I, the energy rows (float64) and dE/dB of the walk, summed by segment
    slots, equal the ordered plain versions ``born_reference`` and
    ``energy_rows_reference`` atom by atom (tile 128, Morton order)."""
    fn, xs = _geometry(name)
    xs = xs[:R]
    close = fn.close_tiles(xs)
    I_ref = fn.born_reference(xs, close)
    assert _rel(walk_born(fn, xs, close), I_ref) <= 1e-5
    B = fn.born_radii(I_ref)[0]
    e, dEdB = walk_energy(fn, xs, B, close)
    ep, dp = fn.energy_rows_reference(xs, B, close)
    assert e.dtype == torch.float64 and _rel(e, ep) <= 1e-5
    assert _rel(dEdB, dp) <= 1e-5
    assert float(ep.abs().max()) > 0.0 and float(dp.abs().max()) > 0.0


@pytest.mark.parametrize("name", GEOMETRIES)
@pytest.mark.parametrize("sweep", ["born", "energy"])
def test_walk_evaluates_each_pair_inside_the_cutoff_once(sweep, name):
    """Over all items, the sweep's walk evaluates every ordered pair that
    ``cutoff_pairs`` keeps (coincident ones left out) exactly once and no
    other pair, though it skips patches and far rows (R = 2)."""
    fn, xs = _geometry(name)
    R, n = xs.shape[:2]
    close = fn.close_tiles(xs)
    visits = torch.zeros((R, n, n), dtype=torch.int32)
    if sweep == "born":
        walk_born(fn, xs, close, visits)
    else:
        walk_energy(fn, xs, torch.ones(R, n), close, visits)
    for rep in range(R):
        d = xs[rep, :, None, :] - xs[rep, None, :, :]
        pairs = cutoff_pairs(d, fn.gb_cutoff) & (_r2(d) > 1e-8)
        assert torch.equal(visits[rep], pairs.int()) and int(pairs.sum()) > 0
    skipped = sum(len(skip) for _, skip in culled_walk(fn, xs, close).values())
    assert skipped > 0


@pytest.mark.parametrize("name", list(CUTOFFS))
def test_walk_sweeps_match_jax_ordered_path(name):
    """A batch of two evaluated with the walk's plain versions as its Born,
    energy and force sweeps against ``pallas_pair.build_pair_force_fn(
    gb_cutoff=, order_from=, newton=False, interpret=True)``, replica by
    replica: energy to 1e-5, forces to 1e-4 of max |F|."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system(name)
    cutoff = CUTOFFS[name]
    kw = dict(tile=128, gb_cutoff=cutoff, order_from=jx, newton=False)
    fn = build_pair_force_fn(system_from_numpy(js.to_dict()), **kw)
    jfn = jax_pair(js, interpret=True, **kw)
    x = _noisy(jx, 2, seed=19)
    te, tf = fn._evaluate(torch.from_numpy(x),
                          lambda xs, close: walk_born(fn, xs, close),
                          lambda xs, B, close: walk_energy(fn, xs, B, close),
                          lambda xs, B, c, close: walk_forces(fn, xs, B, c, close),
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


def test_culled_scratch_sizes():
    """Each culled kernel's scratch in bytes: the 32-atom groups' boxes
    (float32), then the per-segment slots of the sweep (Born 1 float64,
    energy 2, force 3 float32), the slots 8-byte aligned; the force sweep's
    is ``culled_force_scratch`` float32 entries."""
    assert CULLED_SEGMENTS == 4
    for R, n in ((1, 61_824), (3, 33), (2, 1)):
        groups = -(-n // 32)
        assert (R * groups * 6 * 4) % 8 == 0
        for sweep, slot in (("born", 8), ("energy", 16), ("force", 12)):
            assert culled_scratch(sweep, R, n) == R * (groups * 6 * 4 + 4 * n * slot)
        assert culled_scratch("force", R, n) == 4 * culled_force_scratch(R, n)
    assert culled_scratch("born", 1, 61_824) == 1_932 * 24 + 4 * 61_824 * 8


# --- on the card -----------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 3])
def test_culled_born_and_energy_kernels_match_plain_versions_on_the_card(R):
    """Both kernels against ``born_reference`` / ``energy_rows_reference``
    on the same card tensors (3,726 and 276 atoms, tile 128, cutoff 1.5 nm,
    Morton order): I, e_rows and dE/dB to 1e-5 of their max; one launch a
    call, the same bits from a second launch; at 276 atoms against the
    walk's plain versions on the CPU too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for copies in ((3, 3, 3), (2, 1, 1)):
        system, pos = build_system(chignolin_assembly(copies), gb_model="gbn2", device="cuda",
                                   dense_scales=False)
        x = torch.as_tensor(_noisy(pos.cpu().numpy(), R, seed=20, sigma=0.005), device="cuda")
        fn = build_pair_force_fn(system, tile=128, gb_cutoff=1.5, order_from=pos, newton=False)
        xs = fn.to_storage(x)
        close = fn.close_tiles(xs)
        I_ref = fn.born_reference(xs, close)
        B = fn.born_radii(I_ref)[0]
        before = dict(pair_force.launches)
        I, I2 = fn.born(xs, close), fn.born(xs, close)
        (e, d), (e2, d2) = fn.energy_rows(xs, B, close), fn.energy_rows(xs, B, close)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in pair_force.launches.items() if v != before[k]}
        assert delta == {"pair_born_culled": 2, "pair_energy_culled": 2}
        assert torch.equal(I, I2) and torch.equal(e, e2) and torch.equal(d, d2)
        ep, dp = fn.energy_rows_reference(xs, B, close)
        assert _rel(I, I_ref) <= 1e-5
        assert e.dtype == torch.float64 and _rel(e, ep) <= 1e-5 and _rel(d, dp) <= 1e-5
        if copies == (2, 1, 1):
            fc = build_pair_force_fn(system.to("cpu"), tile=128, gb_cutoff=1.5,
                                     order_from=pos.cpu(), newton=False)
            xc, cc, Bc = xs.cpu(), close.cpu(), B.cpu()
            assert _rel(I.cpu(), walk_born(fc, xc, cc)) <= 1e-5
            ew, dw = walk_energy(fc, xc, Bc, cc)
            assert _rel(e.cpu(), ew) <= 1e-5 and _rel(d.cpu(), dw) <= 1e-5
