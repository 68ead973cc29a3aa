"""Row 9 split into x-slabs (``build_cell_force_fn(mesh=)``) over 2 and 4
real gloo ranks on the CPU (spawned once per world size,
``torch_parallel_workers.py``), where each rank's sweep is the plain
version of its slab launch: ``sweep_reference`` over its home cells.

On the dry-run geometry of JAX's ``dryrun_multichip`` (8 x 4 x 4 waters,
cutoff 0.45 nm, nx = 8), orthorhombic, sheared and in PME mode, with a
replica batch through the stateful entries: against the port's unsharded
sweep and against the JAX package's unsharded ``build_cell_force_fn``
(Pallas in interpret mode) with the explicit-parity gates, energies to
1e-5 relative and forces to 1e-4 of max |F|; each rank's scratch below
the unsharded one; the ranks' copies of the state the same bits after
FIRE and ``run_md``. The plain slab sweeps of the ranks add up to the
unsharded plain sweep, pair by pair.
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from pmarlo_tpu_torch.md.cell_force import Slab, build_cell_force_fn


def _assert_close(e, f, e_ref, f_ref, what):
    e, f, e_ref, f_ref = (np.asarray(a, np.float64) for a in (e, f, e_ref, f_ref))
    assert np.abs(e - e_ref).max() <= 1e-5 * np.abs(e_ref).max(), what
    assert np.abs(f - f_ref).max() <= 1e-4 * np.abs(f_ref).max(), what


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, W.spawn("slabs", world, tmp_path_factory.mktemp(f"slab{world}"))


MODES = {"rf": (None, "rf"), "sheared": (W.SLAB_TILT, "rf"), "pme": (None, "pme")}


@pytest.mark.parametrize("mode", list(MODES))
def test_slab_sweep_matches_unsharded_sweep(ranks, mode):
    world, res = ranks
    for out in res:
        m = out["modes"][mode]
        assert m["nx"] == 8
        _assert_close(m["e"], m["f"], m["e0"], m["f0"], f"{mode}, {world} ranks")
        # every rank returns the same energy and forces
        np.testing.assert_array_equal(m["f"], res[0]["modes"][mode]["f"])
        assert m["e"] == res[0]["modes"][mode]["e"]


def test_ranks_copies_stay_the_same_bits_through_fire_and_md(ranks):
    """Every rank holds the whole state and moves it with the summed
    forces: after FIRE and rigid-water ``run_md`` through the slab sweep
    the copies are the same bits (what is not a pair sweep is added on the
    first rank alone, before the one sum)."""
    world, res = ranks
    first = res[0]["in_step"]
    assert np.isfinite(first["md"]).all()
    assert not np.array_equal(first["fire"], first["md"])
    for out in res[1:]:
        for k in ("fire", "md"):
            np.testing.assert_array_equal(out["in_step"][k], first[k], err_msg=f"{k}, {world}")


@pytest.mark.parametrize("mode", list(MODES))
def test_slab_sweep_matches_jax_unsharded_kernel(ranks, mode):
    import jax.numpy as jnp
    from pmarlo_tpu.io import pdb as jax_pdb
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu.md.pallas_cells import build_cell_force_fn as jax_build

    world, res = ranks
    tilt, elec = MODES[mode]
    structure, box = W.lattice(pdb=jax_pdb)
    jsys, _ = jax_build_system(structure, box=box, tilt=tilt, cutoff=0.45,
                               hydrogen_mass=None)
    # skin 0: JAX's grid is then the port's (its dry run shears with skin 0)
    jfn = jax_build(jsys, interpret=True, electrostatics=elec, skin=0.0)
    assert (jfn.grid.nx, jfn.grid.ny, jfn.grid.nz) == (8, 4, 4)
    m = res[0]["modes"][mode]
    ek, fk = jfn(jnp.asarray(m["x"]))
    _assert_close(m["e"], m["f"], float(ek), np.asarray(fk), f"{mode} vs JAX, {world} ranks")
    for r in range(2):
        ek, fk = jfn(jnp.asarray(m["xs"][r]))
        _assert_close(m["eb"][r], m["fb"][r], float(ek), np.asarray(fk),
                      f"{mode} batched replica {r} vs JAX, {world} ranks")


def test_slab_scratch_is_below_the_unsharded_scratch(ranks):
    world, res = ranks
    for out in res:
        m = out["modes"]["rf"]
        assert m["serial_local_shapes"] is None
        assert m["local_shapes"] == {"home_cells": 8 // world * 16,
                                     "slab_cells": (8 // world + 1) * 16}
        # the extended slab holds (cxl + 1) / nx of the lattice's 384 atoms
        assert m["scratch0"] == 384 * 928
        assert m["scratch"] == 384 * (8 // world + 1) // 8 * 928
        assert m["scratch"] < m["scratch0"]
    if world == 4:
        assert res[0]["modes"]["rf"]["scratch"] < 384 * 5 // 8 * 928


def test_slab_refusals_are_jax_s(ranks):
    world, res = ranks
    for out in res:
        ref = out["refusals"]
        assert ref["indivisible"] == (
            f"spatial decomposition needs n_cells_x (7) divisible by the mesh size ({world})")
        if world == 2:
            assert ref["too_small"].startswith(
                "grid too small for sharded binning: the 1-layer slab's halo window "
                "(3 x-layers) exceeds the 2-layer grid")
        else:
            assert "divisible by the mesh size (4)" in ref["too_small"]
        assert "DeviceMesh" in ref["not_a_mesh"]


class _Rank:
    """What ``Slab`` reads of a mesh, for one rank of ``n``."""

    def __init__(self, n, r):
        self.n, self.r = n, r

    def size(self):
        return self.n

    def get_local_rank(self):
        return self.r


@pytest.mark.parametrize("tilt", [None, W.SLAB_TILT], ids=["orthorhombic", "sheared"])
@pytest.mark.parametrize("n", [2, 4])
def test_plain_slab_sweeps_add_up_to_the_unsharded_sweep(tilt, n):
    """In one process: each rank's home cells and the slab atoms the
    kernel is handed. The slabs' pairs are the unsharded sweep's, each
    once; the atoms are the interior's and the +x halo layer's, in
    sorted order, with CSR offsets on the slab grid."""
    system, x = W.slab_waters(tilt=tilt)
    fn = build_cell_force_fn(system)
    st = fn._bin(W.jiggle(x, 3)[None])
    pairs = set()
    for ai, aj, *_ in fn.half_shell(st.xw[0], st.order[0], st.cell_start[0]):
        pairs.update(zip(ai.tolist(), aj.tolist()))
    e, f = fn.sweep_reference(st.xw, st.order, st.cell_start)
    es, fs, slab_pairs = 0.0, torch.zeros_like(f), []
    cs = st.cell_start[0]
    for r in range(n):
        sl = Slab(fn.grid, _Rank(n, r))
        assert (sl.lo, sl.hi) == (r * 128 // n, (r + 1) * 128 // n)
        assert sl.halo == (r + 1) * 8 // n % 8 and sl.wraps == (r == n - 1)
        ee, ff = fn.sweep_reference(st.xw, st.order, st.cell_start, home=(sl.lo, sl.hi))
        es, fs = es + ee.sum(), fs + ff
        for ai, aj, *_ in fn.half_shell(st.xw[0], st.order[0], cs, home=(sl.lo, sl.hi)):
            slab_pairs += list(zip(ai.tolist(), aj.tolist()))
        local, lcs = sl.atoms(st.order[0], cs)
        h = sl.halo * 16
        expect = torch.cat([st.order[0][cs[sl.lo]:cs[sl.hi]], st.order[0][cs[h]:cs[h + 16]]])
        assert torch.equal(local.long(), expect)
        assert lcs.shape == (sl.dims[0] * 16 + 1,) and int(lcs[-1]) == local.shape[0]
        assert (torch.diff(lcs) >= 0).all()
    assert len(slab_pairs) == len(set(slab_pairs)) and set(slab_pairs) == pairs
    assert abs(float(es - e.sum())) <= 1e-12 * abs(float(e.sum()))
    assert float((fs - f).abs().max()) <= 1e-6 * float(f.abs().max())
