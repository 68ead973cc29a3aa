"""The multi-rank paths on the card: two ranks share ``cuda:0`` through
gloo (NCCL refuses two ranks on one device), spawned once
(``torch_parallel_workers.py``; this file imports no JAX, so it also runs
where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_parallel_card.py``).

The plain dense forces and the pair path's repeat bit for bit, and for a
batch split in two. Rows 3-5 under a replica mesh: chignolin REMD through
the pair kernels at R = 4 over 2 ranks, from one minimized structure,
against the same run in one process (identical
``replica_ids`` and acceptance, frames within 1e-4 nm), every rank
launching the three pair kernels. Row 9's slab launch (``cell_force.cu
pmarlo_cell_force_slab``) on the dry-run lattice (orthorhombic, sheared,
PME) and a 12^3 water box: the whole evaluation against the unsharded
kernel and this rank's partial sweep against its plain version (energies
1e-5 relative, forces 1e-4 of max |F|), two launches bitwise equal, the
scratch below the unsharded one; the ranks' copies of the box the same
bits after FIRE and ``run_md`` through it.
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as W


def _assert_close(e, f, e_ref, f_ref, what):
    assert abs(e - e_ref) <= 1e-5 * abs(e_ref), what
    assert np.abs(f - f_ref).max() <= 1e-4 * np.abs(f_ref).max(), what


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pair and cell kernels run on it")
    from pmarlo_tpu_torch import _kernels

    _kernels.library()          # built once here, not by both ranks


@pytest.fixture(scope="module")
def x_min(card):
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    system, x, fn = W.card_chignolin()
    return minimize_energy(system, x, force_fn=fn)[0].cpu().numpy()


@pytest.fixture(scope="module")
def ranks(card, x_min, tmp_path_factory):
    return W.spawn("card", 2, tmp_path_factory.mktemp("card"), x_min=x_min)


@pytest.mark.gpu
def test_force_paths_repeat_bit_for_bit_for_any_batch(card):
    """What lets a rank's block reproduce the one-process run: the plain
    dense forces (row 1's twin) and the pair path's, twice on the same
    positions and for the batch split in two, are the same bits (the
    bonded terms and the band correction add in a fixed order); the
    energies agree to 1e-5 (the repo's energy gate)."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_structure
    from pmarlo_tpu_torch.md.analytic import energy_and_forces, make_dense_params
    from pmarlo_tpu_torch.md.forcefield import build_system

    _, x, fn = W.card_chignolin()
    dense = make_dense_params(build_system(chignolin_structure(), gb_model="gbn2",
                                           device="cuda")[0])
    xs = torch.stack([W.jiggle(x.float(), s, 0.005) for s in range(4)])
    for f in (fn, lambda y: energy_and_forces(dense, y)):
        e4, f4 = f(xs)
        e4b, f4b = f(xs)
        assert torch.equal(f4, f4b) and torch.equal(e4, e4b)
        halves = [f(xs[i:i + 2]) for i in (0, 2)]
        assert torch.equal(torch.cat([h[1] for h in halves]), f4)
        # the energies' sums may round differently (they only decide swaps)
        torch.testing.assert_close(torch.cat([h[0] for h in halves]), e4, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_ranks_share_the_card_through_gloo(ranks):
    for out in ranks:
        assert out["device_type"] == "cuda" and out["backend"] == "gloo"


@pytest.mark.gpu
def test_pair_path_remd_under_a_mesh_matches_one_process(ranks, x_min):
    ref = W.card_pair_remd(x_min)
    for out in ranks:
        res = out["pair_remd"]
        np.testing.assert_array_equal(res.replica_ids, ref.replica_ids)
        np.testing.assert_array_equal(res.acceptance_matrix, ref.acceptance_matrix)
        np.testing.assert_allclose(res.positions, ref.positions, atol=1e-4, rtol=0)
        for name in ("pair_born", "pair_energy", "pair_force"):
            assert out["pair_launches"][name] > 0, name


@pytest.mark.gpu
def test_slab_ranks_copies_stay_the_same_bits(ranks):
    """200 FIRE iterations and 200 rigid-water steps of the 12^3 box
    through the slab launch: the ranks' copies are the same bits (the
    band correction, bonded terms and PME add with atomics on the first
    rank only, before the one sum)."""
    first = ranks[0]["in_step"]
    assert np.isfinite(first["md"]).all()
    for out in ranks[1:]:
        for k in ("fire", "md"):
            np.testing.assert_array_equal(out["in_step"][k], first[k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["rf", "sheared", "pme", "water_box"])
def test_slab_launch_matches_unsharded_kernel_and_plain(ranks, mode):
    for out in ranks:
        m = out["slabs"][mode]
        assert m["launched"] == 2 and m["bitwise"]
        _assert_close(*m["partial"], f"{mode}: slab launch vs plain slab sweep")
        _assert_close(*m["whole"], f"{mode}: slab evaluation vs unsharded kernel")
        assert m["scratch"][0] < m["scratch"][1]
