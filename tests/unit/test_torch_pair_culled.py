"""The large-assembly pair path of ``pmarlo_tpu_torch/md/pair_force.py``:
``gb_cutoff`` (every pair term cut, tile blocks out of range skipped),
``order_from`` (Morton storage order), ``newton`` (each unordered tile block
once) and ``bonded``.

Against the JAX package: ``pallas_pair.build_pair_force_fn(gb_cutoff=,
order_from=, newton=, interpret=True)`` on the CPU, the same system and
positions (made with numpy from a seed) on both sides. Then the JAX tests'
own properties (``tests/unit/test_pallas_pair_culled.py``) on the port's
plain versions, the tile-skip logic, a geometry on which the JAX tile lists
overflow, and the kernels against their plain versions on the card
(``gpu``-marked; they skip here).

JAX is imported inside the tests that compare against it, so that the
``gpu`` tests also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_pair_culled.py``.

Tolerances: energies to 1e-5 relative or 1e-3 kJ/mol and forces to 1e-4 of
max |F|, the float32 rounding of sums taken in another order. The force
jumps at the cutoff, and the two packages round r^2 differently, so atoms
with a pair within 1e-5 relative of the cutoff are counted and left out of
the force comparison with JAX.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure, replicate_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
from pmarlo_tpu_torch.md import pair_force
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.pair_force import (
    _morton_order,
    build_pair_force_fn,
    cutoff_pairs,
    cutoff_r2,
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
    "alanine": lambda: alanine_dipeptide_structure(),
    # two copies 8 nm apart: adjacent atom indices across the chain boundary
    "two_clusters": lambda: _alanines((2, 1, 1), (8.0, 0.0, 0.0)),
    "assembly_132": lambda: _alanines((3, 2, 1), (1.1, 1.1, 1.1)),
    "chignolin_276": lambda: chignolin_assembly((2, 1, 1)),
}


def _jax_system(name):
    """The JAX package's system and positions for a structure of
    ``STRUCTURES``."""
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s = STRUCTURES[name]()
    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    js, jx = jax_build_system(PDBStructure(residues=residues), gb_model="gbn2")
    return js, np.array(jx, np.float32)


@pytest.fixture(scope="module")
def systems():
    """The port's system and float32 positions by structure name."""
    cache = {}

    def get(name):
        if name not in cache:
            system, pos = build_system(STRUCTURES[name](), gb_model="gbn2", device="cpu")
            cache[name] = (system, pos.float())
        return cache[name]

    return get


def _near_cutoff_atoms(x, cutoff, tol=1e-5):
    """``(N,)`` bool: atoms of ``x (N, 3)`` with a pair whose distance is
    within ``tol`` relative of the cutoff (float64)."""
    xd = torch.as_tensor(x, dtype=torch.float64)
    r = torch.cdist(xd, xd)
    return ((r - cutoff).abs() <= tol * cutoff).any(-1)


def _close(e, f, e_ref, f_ref, keep=None):
    e, e_ref = float(e), float(e_ref)
    assert abs(e - e_ref) <= max(1e-5 * abs(e_ref), 1e-3), (e, e_ref)
    f, f_ref = np.asarray(f), np.asarray(f_ref)
    if keep is not None:
        f, f_ref = f[keep], f_ref[keep]
    assert np.abs(f - f_ref).max() <= 1e-4 * np.abs(f_ref).max()


# --- against the JAX package ---------------------------------------------------------


@pytest.mark.parametrize("newton", [False, True], ids=["ordered", "newton"])
@pytest.mark.parametrize("name,cutoff", [("two_clusters", 2.0), ("assembly_132", 1.5)])
def test_culled_path_matches_jax(name, cutoff, newton):
    """The port's culled evaluation in Morton order against JAX's culled
    Pallas sweeps (interpret mode), ordered and Newton, with JAX's own band
    and its Morton permutation equal to the port's."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_pair import _morton_order as jax_morton
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system(name)
    ts = system_from_numpy(js.to_dict())
    rng = np.random.default_rng(11)
    x = (jx + rng.normal(0.0, 0.01, jx.shape)).astype(np.float32)
    je, jf = jax_pair(js, tile=128, interpret=True, gb_cutoff=cutoff, order_from=jx,
                      newton=newton)(jnp.asarray(x))
    fn = build_pair_force_fn(ts, tile=128, gb_cutoff=cutoff, order_from=jx, newton=newton)
    np.testing.assert_array_equal(fn.perm.numpy(), jax_morton(jx))
    te, tf = fn(torch.from_numpy(x))
    near = _near_cutoff_atoms(x, cutoff).numpy()
    assert near.sum() <= 4
    _close(te, tf.numpy(), je, np.asarray(jf), keep=~near)


def test_bonded_window_equals_gather_on_the_culled_path():
    """``bonded="window"`` against ``bonded="gather"`` on the port, and
    both against JAX's culled Newton path with ``bonded="window"``."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system("assembly_132")
    ts = system_from_numpy(js.to_dict())
    kw = dict(tile=128, gb_cutoff=1.5, order_from=jx)
    eg, fg = build_pair_force_fn(ts, bonded="gather", **kw)(torch.from_numpy(jx))
    fn_w = build_pair_force_fn(ts, bonded="window", **kw)
    assert fn_w._bonded_kernel is not None and fn_w._bonded_kernel.far_terms == 0
    ew, fw = fn_w(torch.from_numpy(jx))
    torch.testing.assert_close(ew, eg, rtol=1e-6, atol=0)
    torch.testing.assert_close(fw, fg, rtol=0, atol=1e-6 * float(fg.abs().max()))
    je, jf = jax_pair(js, interpret=True, bonded="window", **kw)(jnp.asarray(jx))
    _close(ew, fw.numpy(), je, np.asarray(jf), keep=~_near_cutoff_atoms(jx, 1.5).numpy())


def test_constrained_run_md_on_the_culled_path_matches_jax():
    """20 constrained steps at friction 0, 4 fs, through each package's
    culled Newton path (Morton order, cutoff 1.5 nm) on two chignolins:
    positions to 1e-4 nm, frame energies to 1e-5 relative, temperatures to
    1e-3 relative, step for step the same algorithm."""
    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.md.constraints import build_h_constraints as jax_constraints
    from pmarlo_tpu.md.constraints import strip_constrained_bonded as jax_strip
    from pmarlo_tpu.md.integrate import MDState as JaxMDState
    from pmarlo_tpu.md.integrate import run_md as jax_run_md
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
    from pmarlo_tpu_torch.md.constraints import (
        build_h_constraints,
        constraint_violation,
        strip_constrained_bonded,
    )
    from pmarlo_tpu_torch.md.integrate import MDState, run_md

    js, jx = _jax_system("chignolin_276")
    ts = system_from_numpy(js.to_dict())
    rng = np.random.default_rng(2)
    m = ts.masses.numpy()
    v0 = (np.sqrt(BOLTZMANN_CONSTANT_KJ_PER_MOL * 300.0 / m)[:, None]
          * rng.standard_normal(jx.shape)).astype(np.float32)
    kw = dict(n_steps=20, dt=0.004, friction=0.0, temperature_K=300.0, report_interval=10)
    cut = dict(tile=128, gb_cutoff=1.5, order_from=jx)

    jfn = jax_pair(jax_strip(js), interpret=True, **cut)
    jstate = JaxMDState(positions=jnp.asarray(jx), velocities=jnp.asarray(v0),
                        key=jax.random.PRNGKey(0), step=jnp.asarray(0, jnp.int32))
    jfinal, jframes = jax_run_md(js, jstate, force_fn=jfn,
                                 constraints=jax_constraints(js, layout="onehot"), **kw)

    spec = build_h_constraints(ts)
    fn = build_pair_force_fn(strip_constrained_bonded(ts), **cut)
    assert fn.newton and fn.mode == "newton"
    state = MDState(positions=torch.from_numpy(jx), velocities=torch.from_numpy(v0),
                    seeds=torch.tensor(0, dtype=torch.int32), step=0)
    final, frames = run_md(ts, state, force_fn=fn, constraints=spec, **kw)

    np.testing.assert_allclose(final.positions.numpy(), np.asarray(jfinal.positions),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(frames["positions"].numpy(),
                               np.asarray(jframes["positions"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(frames["potential_energy"].numpy(),
                               np.asarray(jframes["potential_energy"]), rtol=1e-5)
    np.testing.assert_allclose(frames["temperature"].numpy(),
                               np.asarray(jframes["temperature"]), rtol=1e-3)
    assert float(constraint_violation(spec, final.positions)) <= 1e-5


# --- the JAX tests' properties, on the port ------------------------------------------


@pytest.mark.parametrize("newton", [False, True], ids=["ordered", "newton"])
def test_huge_cutoff_matches_dense(systems, newton):
    system, x = systems("assembly_132")
    e0, f0 = build_pair_force_fn(system, tile=32)(x)
    e1, f1 = build_pair_force_fn(system, tile=32, gb_cutoff=50.0, newton=newton)(x)
    _close(e1, f1, e0, f0)


@pytest.mark.parametrize("newton", [False, True], ids=["ordered", "newton"])
def test_morton_order_is_layout_only(systems, newton):
    system, x = systems("two_clusters")
    kw = dict(tile=32, gb_cutoff=2.0, newton=newton)
    fn_mo = build_pair_force_fn(system, order_from=x, **kw)
    assert not np.array_equal(fn_mo.perm.numpy(), np.arange(system.n_atoms))
    e1, f1 = build_pair_force_fn(system, **kw)(x)
    e2, f2 = fn_mo(x)
    _close(e2, f2, e1, f1)
    # storage order round trip, and a batch of replicas
    xb = torch.stack([x, x + 0.01])
    torch.testing.assert_close(fn_mo.from_storage(fn_mo.to_storage(xb)), xb, rtol=0, atol=0)
    eb, fb = fn_mo(xb)
    assert eb.shape == (2,) and fb.shape == xb.shape
    _close(eb[0], fb[0], e2, f2)


def test_two_cluster_energy_decomposes(systems):
    """E(A + B; cutoff) = E(A) + E(B) for clusters beyond the cutoff:
    descreening, LJ, Coulomb, the GB cross term and the band add-back across
    the chain boundary (|i - j| <= D at 8 nm) all truncate together."""
    s1, x1 = systems("alanine")
    s2, x2 = systems("two_clusters")
    e1, f1 = build_pair_force_fn(s1, tile=32)(x1)
    for newton in (False, True):
        e2, f2 = build_pair_force_fn(s2, tile=32, gb_cutoff=2.0, order_from=x2,
                                     newton=newton)(x2)
        assert abs(float(e2) - 2.0 * float(e1)) <= 5e-3
        # the second copy only to float32 granularity at its 8 nm offset
        assert float((f2[:22] - f1).abs().max()) <= 2e-3


@pytest.mark.parametrize("newton", [False, True], ids=["ordered", "newton"])
def test_culled_equals_masked_on_one_tile(systems, newton):
    """Culling is a pure skip: tiles of 32 in Morton order against the same
    cutoff physics with every atom in one tile (nothing to skip)."""
    system, x = systems("assembly_132")
    e1, f1 = build_pair_force_fn(system, tile=256, gb_cutoff=1.0, newton=False)(x)
    fn = build_pair_force_fn(system, tile=32, gb_cutoff=1.0, order_from=x, newton=newton)
    assert float(fn.close_tiles(fn.to_storage(x[None])).float().mean()) < 1.0
    e2, f2 = fn(x)
    _close(e2, f2, e1, f1)


def test_dense_newton_matches_dense(systems):
    """Without a cutoff the Newton sweeps take the whole upper triangle:
    each unordered pair once, scattered to both atoms."""
    system, x = systems("two_clusters")
    e0, f0 = build_pair_force_fn(system, tile=32, newton=False)(x)
    fn = build_pair_force_fn(system, tile=32, newton=True)
    assert fn.mode == "newton" and fn.gb_cutoff is None
    e1, f1 = fn(x)
    _close(e1, f1, e0, f0)


def test_newton_sweeps_equal_ordered_sweeps(systems):
    """Sweep by sweep on a batch in storage order: the Born integrals,
    dE/dB and forces agree, and the energy rows sum to the same totals
    (a Newton row holds the pairs of the later atoms only)."""
    system, x0 = systems("assembly_132")
    rng = np.random.default_rng(5)
    x = x0[None] + torch.as_tensor(rng.normal(0.0, 0.01, (2,) + tuple(x0.shape)),
                                   dtype=torch.float32)
    kw = dict(tile=32, gb_cutoff=1.2, order_from=x0)
    fo = build_pair_force_fn(system, newton=False, **kw)
    fn = build_pair_force_fn(system, newton=True, **kw)
    xs = fo.to_storage(x)
    Io, In = fo.born(xs), fn.born(xs)
    torch.testing.assert_close(In, Io, rtol=0, atol=1e-5 * float(Io.abs().max()))
    B, dB = fo.born_radii(Io)
    (eo, do), (en, dn) = fo.energy_rows(xs, B), fn.energy_rows(xs, B)
    assert eo.dtype == en.dtype == torch.float64
    torch.testing.assert_close(en.sum(-1), eo.sum(-1), rtol=1e-9, atol=0)
    assert not torch.allclose(en, eo)
    torch.testing.assert_close(dn, do, rtol=0, atol=1e-5 * float(do.abs().max()))
    _, c = fo.gb_terms(B, dB, do)
    Fo, Fn = fo.pair_forces(xs, B, c), fn.pair_forces(xs, B, c)
    torch.testing.assert_close(Fn, Fo, rtol=0, atol=1e-5 * float(Fo.abs().max()))


@pytest.fixture(scope="module")
def spread_line():
    """120 alanines on a 6 nm-spaced line (2,640 atoms, 21 tiles of 128):
    sparse at build time. ``packed`` are the same molecules on a 0.9 nm
    grid of 5 x 5 x 5 sites, a 4 nm cube in which every tile is within the
    cutoff of most others."""
    system, x0 = build_system(_alanines((120, 1, 1), (6.0, 0.0, 0.0)), gb_model="gbn2",
                              dense_scales=False, device="cpu")
    x0 = x0.float()
    copy = torch.arange(120)
    site = torch.stack([copy // 25, (copy // 5) % 5, copy % 5], -1).float() * 0.9
    line = torch.stack([copy * 6.0, torch.zeros(120), torch.zeros(120)], -1)
    packed = x0 + (site - line).repeat_interleave(22, 0)
    return system, x0, packed


def test_sparse_system_newton_equals_ordered(spread_line):
    system, x0, _ = spread_line
    kw = dict(tile=128, gb_cutoff=1.5, order_from=x0)
    fo = build_pair_force_fn(system, newton=False, **kw)
    assert float(fo.close_tiles(fo.to_storage(x0[None])).float().mean()) < 0.2
    e0, f0 = fo(x0)
    e1, f1 = build_pair_force_fn(system, newton=True, **kw)(x0)
    _close(e1, f1, e0, f0)


def test_no_tile_list_to_overflow(spread_line):
    """The packed geometry overflows both of JAX's statically sized tile
    lists (its evaluation there is NaN-poisoned); the port has no list and
    evaluates it: ordered = Newton = the same physics on one tile."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
    from pmarlo_tpu.data import replicate_structure as jax_replicate

    system, x0, packed = spread_line
    js, jx0 = jax_build_system(
        jax_replicate(jax_alanine(), n=(120, 1, 1), spacing=(6.0, 0.0, 0.0)),
        gb_model="gbn2", dense_scales=False)
    np.testing.assert_allclose(np.asarray(jx0), x0.numpy(), atol=1e-6)
    for newton in (False, True):
        jfn = jax_pair(js, tile=128, interpret=True, gb_cutoff=1.5,
                       order_from=np.asarray(jx0), newton=newton)
        assert not bool(jfn.check_overflow(jnp.asarray(x0.numpy())))
        assert bool(jfn.check_overflow(jnp.asarray(packed.numpy())))

    kw = dict(gb_cutoff=1.5, order_from=x0)
    fo = build_pair_force_fn(system, tile=128, newton=False, **kw)
    assert not hasattr(fo, "check_overflow") and not hasattr(fo, "tile_list_width")
    e0, f0 = fo(packed)
    assert bool(torch.isfinite(e0)) and bool(torch.isfinite(f0).all())
    e1, f1 = build_pair_force_fn(system, tile=128, newton=True, **kw)(packed)
    e2, f2 = build_pair_force_fn(system, tile=2688, gb_cutoff=1.5, newton=False)(packed)
    _close(e1, f1, e0, f0)
    _close(e0, f0, e2, f2)


# --- the tile skip ---------------------------------------------------------------------


@pytest.mark.parametrize("geometry", ["random", "collapsed", "line"])
def test_skipped_tile_blocks_hold_no_pair_within_the_cutoff(geometry):
    """``tiles_within`` against brute force: a block it excludes holds no
    pair that ``cutoff_pairs`` keeps; a block it keeps is within reach of
    the boxes; ragged last tile, batch of two."""
    rng = np.random.default_rng(3)
    n, tile, cutoff = 333, 32, 0.9
    x = rng.uniform(0.0, 4.0, (2, n, 3))
    if geometry == "random":
        x = np.stack([xr[_morton_order(xr)] for xr in x])
    elif geometry == "collapsed":
        x *= 0.05
    elif geometry == "line":
        x[..., 1:] *= 0.01
        x = np.sort(x, axis=1)
    x = torch.as_tensor(x, dtype=torch.float32)
    lo, hi = tile_boxes(x, tile)
    G = -(-n // tile)
    assert lo.shape == hi.shape == (2, G, 3)
    np.testing.assert_array_equal(lo[:, -1].numpy(), x[:, (G - 1) * tile:].amin(1).numpy())
    close = tiles_within(lo, hi, cutoff)
    assert close.shape == (2, G, G) and close.dtype == torch.bool
    assert bool(close.diagonal(dim1=1, dim2=2).all())
    assert torch.equal(close, close.transpose(1, 2))
    pairs = cutoff_pairs(x[:, :, None, :] - x[:, None, :, :], cutoff)       # (2, n, n)
    pad = G * tile - n
    pairs = torch.nn.functional.pad(pairs, (0, pad, 0, pad))
    any_pair = pairs.reshape(2, G, tile, G, tile).any(4).any(2)
    assert not bool((any_pair & ~close).any())
    if geometry == "collapsed":
        assert bool(close.all())
    else:
        assert 0.0 < float(close.float().mean()) < 1.0


def test_cutoff_pairs_decides_on_float32():
    """The pair test is ``sqrt(r^2 + 1e-12) <= cutoff`` in float32, whatever
    type the displacements come in."""
    d = torch.tensor([[0.6, 0.8, 0.0], [0.6, 0.8, 1e-3], [0.0, 0.0, 0.0]], dtype=torch.float64)
    assert cutoff_pairs(d, 1.0).tolist() == [True, False, True]
    assert cutoff_pairs(d.float(), 1.0).tolist() == cutoff_pairs(d, 1.0).tolist()
    assert cutoff_pairs(d, 1.0).dtype == torch.bool


@pytest.mark.parametrize("cutoff", [0.3, 1.0, 1.5, 2.0, 50.0])
def test_cutoff_r2_decides_as_the_square_root_does(cutoff):
    """``s <= cutoff_r2(cutoff)`` is ``sqrt(s) <= cutoff`` for every float32
    ``s``: checked on the 2,001 floats around the threshold and on random
    ones, and through ``cutoff_pairs`` on displacements at the cutoff."""
    t = np.float32(cutoff_r2(cutoff))
    assert float(t) == cutoff_r2(cutoff)                     # a float32 number
    c = np.float32(cutoff)
    near = t.view(np.int32) + np.arange(-1000, 1001, dtype=np.int32)
    rng = np.random.default_rng(int(cutoff * 10))
    s = np.concatenate([near.view(np.float32),
                        rng.uniform(0.0, 4.0 * cutoff**2, 10_000).astype(np.float32)])
    np.testing.assert_array_equal(s <= t, np.sqrt(s) <= c)
    assert np.sqrt(t) <= c < np.sqrt(np.nextafter(t, np.float32(np.inf)))
    # displacements whose length is within rounding of the cutoff
    u = rng.normal(size=(4_000, 3))
    u *= (cutoff * (1.0 + rng.uniform(-3e-7, 3e-7, 4_000)) / np.linalg.norm(u, axis=1))[:, None]
    d = torch.as_tensor(u, dtype=torch.float32)
    r2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    by_root = torch.sqrt(r2 + 1e-12) <= torch.tensor(cutoff, dtype=torch.float32)
    assert cutoff_pairs(d, cutoff).tolist() == by_root.tolist()
    assert 0 < int(by_root.sum()) < by_root.numel()


def test_morton_order_groups_space():
    """The host copy's permutation is one, and makes consecutive atoms
    neighbours: tiles of a Morton-ordered cloud have smaller boxes."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0.0, 5.0, (512, 3))
    perm = _morton_order(x)
    assert perm.dtype == np.int32 and sorted(perm.tolist()) == list(range(512))
    xs = torch.as_tensor(x, dtype=torch.float32)[None]
    extent = lambda a: float((tile_boxes(a, 32)[1] - tile_boxes(a, 32)[0]).mean())  # noqa: E731
    assert extent(xs[:, perm]) < 0.6 * extent(xs)


# --- arguments --------------------------------------------------------------------------


def test_argument_checks(systems):
    system, x = systems("alanine")
    with pytest.raises(ValueError, match="order_from"):
        build_pair_force_fn(system, order_from=np.zeros((22, 3)))
    with pytest.raises(ValueError, match="one position per atom"):
        build_pair_force_fn(system, gb_cutoff=2.0, order_from=np.zeros((21, 3)))
    with pytest.raises(ValueError, match="auto|gather|window"):
        build_pair_force_fn(system, bonded="roll")
    with pytest.raises(ValueError, match="positive"):
        build_pair_force_fn(system, gb_cutoff=0.0)
    # the defaults of pallas_pair.build_pair_force_fn
    assert build_pair_force_fn(system).mode == "dense"
    assert build_pair_force_fn(system, gb_cutoff=2.0).mode == "newton"
    assert build_pair_force_fn(system, gb_cutoff=2.0, newton=False).mode == "culled"
    assert build_pair_force_fn(system, gb_cutoff=2.0).bonded == "gather"   # < 8,192 atoms
    assert build_pair_force_fn(system, gb_cutoff=2.0, bonded="window").bonded == "window"
    assert build_pair_force_fn(system, gb_cutoff=2.0, order_from=x).perm is not None


def test_cpu_tensors_never_launch_and_odd_tiles_raise_on_launch(systems):
    """On the CPU every mode runs its plain versions; a launch refuses CPU
    tensors, and tiles the kernels cannot take."""
    system, x = systems("alanine")
    before = dict(pair_force.launches)
    for kw in (dict(gb_cutoff=2.0, newton=False), dict(gb_cutoff=2.0), dict(newton=True)):
        fn = build_pair_force_fn(system, tile=32, **kw)
        ea, fa = fn(x)
        eb, fb = fn.reference(x)
        assert torch.equal(ea, eb) and torch.equal(fa, fb)
        with pytest.raises(RuntimeError, match="CUDA"):
            fn._launch("born", x[None])
    assert pair_force.launches == before
    assert set(before) == {pair_force.kernel_name(s, m) for s in ("born", "energy", "force")
                           for m in ("dense", "culled", "newton")}
    checks = lambda fn: fn._check_cuda("k", torch.empty(0))  # noqa: E731
    for kw, what in ((dict(gb_cutoff=2.0, newton=False, tile=48), "multiples of 32"),
                     (dict(gb_cutoff=2.0, tile=48), "multiples of 32"),
                     (dict(newton=True, tile=48), "multiples of 32")):
        fn = build_pair_force_fn(system, **kw)
        fn(x)                                   # the plain versions take any tile
        with pytest.raises((ValueError, RuntimeError), match=what + "|CUDA"):
            checks(fn)


# --- on the card ------------------------------------------------------------------------


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("newton", [False, True], ids=["culled", "newton"])
@pytest.mark.parametrize("copies,cutoff", [((2, 1, 1), 1.0), ((3, 3, 3), 1.5)],
                         ids=["276_atoms", "3726_atoms"])
def test_kernels_match_plain_versions_on_the_card(copies, cutoff, newton):
    """Each culled or Newton sweep against its plain version on the same
    card tensors (R = 3, Morton order): I and dE/dB to 1e-5 of their max,
    e_rows to 1e-5, forces to 1e-4 of max |F|, the whole evaluation's
    energy to 1e-5; one launch a sweep, none of the dense kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    system, pos = build_system(chignolin_assembly(copies), gb_model="gbn2",
                               device="cuda", dense_scales=False)
    rng = np.random.default_rng(8)
    x = pos[None] + torch.as_tensor(rng.normal(0.0, 0.005, (3,) + tuple(pos.shape)),
                                    dtype=torch.float32, device="cuda")
    fn = build_pair_force_fn(system, tile=128, gb_cutoff=cutoff, order_from=pos,
                             newton=newton, bonded="window")
    before = dict(pair_force.launches)
    xs = fn.to_storage(x)
    Ip = fn.born_reference(xs)
    assert _rel(fn.born(xs), Ip) <= 1e-5
    B, dB = fn.born_radii(Ip)
    ek, dk = fn.energy_rows(xs, B)
    ep, dp = fn.energy_rows_reference(xs, B)
    assert _rel(ek, ep) <= 1e-5 and _rel(dk, dp) <= 1e-5
    _, c = fn.gb_terms(B, dB, dp)
    assert _rel(fn.pair_forces(xs, B, c), fn.pair_forces_reference(xs, B, c)) <= 1e-4
    e, f = fn(x)
    er, fr = fn.reference(x)
    torch.cuda.synchronize()
    assert _rel(e, er) <= 1e-5 and _rel(f, fr) <= 1e-4
    assert bool(torch.isfinite(f).all())
    mode = "newton" if newton else "culled"
    delta = {k: v - before[k] for k, v in pair_force.launches.items() if v != before[k]}
    assert delta == {pair_force.kernel_name(s, mode): 2 for s in ("born", "energy", "force")}


@pytest.mark.gpu
def test_dense_newton_kernels_match_dense_kernels_on_the_card():
    """No cutoff: the Newton kernels over the whole upper triangle against
    the dense kernels (3,726 atoms, R = 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    system, pos = build_system(chignolin_assembly((3, 3, 3)), gb_model="gbn2",
                               device="cuda", dense_scales=False)
    x = torch.stack([pos, pos + 0.003])
    e0, f0 = build_pair_force_fn(system)(x)
    e1, f1 = build_pair_force_fn(system, newton=True)(x)
    assert _rel(e1, e0) <= 1e-5 and _rel(f1, f0) <= 1e-4


@pytest.mark.gpu
def test_packed_geometry_evaluates_on_the_card(spread_line):
    """The geometry that overflows JAX's tile lists, through the kernels:
    finite, ordered = Newton = the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    system, x0, packed = spread_line
    system, x0, packed = system.to("cuda"), x0.cuda(), packed.cuda()
    kw = dict(tile=128, gb_cutoff=1.5, order_from=x0)
    fo = build_pair_force_fn(system, newton=False, **kw)
    e0, f0 = fo(packed)
    e1, f1 = build_pair_force_fn(system, newton=True, **kw)(packed)
    er, fr = fo.reference(packed)
    assert bool(torch.isfinite(f0).all()) and bool(torch.isfinite(f1).all())
    for e, f in ((e0, f0), (e1, f1)):
        assert _rel(e, er) <= 1e-5 and _rel(f, fr) <= 1e-4
