"""Replica-sharded REMD (``ReplicaExchange(mesh=)``, ``run_replica_exchange
(mesh=)``, ``load_checkpoint(mesh=)``) over 2 and 4 real gloo ranks on the
CPU against the port's serial run (spawned once per world size,
``torch_parallel_workers.py``).

Gates (JAX's, ``tests/integration/test_end_to_end.py``): identical
``replica_ids`` history and acceptance, frames within 1e-4 nm, energies
within 2e-3 relative and 0.05 kJ/mol. The CPU's
vectorised transcendental functions round a tensor's tail in its scalar
loop, so a rung's forces can differ in the last bit between a batch of R
and a rank's block of R / n: the frames agree to rounding, not bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from pmarlo_tpu_torch.remd.checkpoint import load_checkpoint
from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange


@pytest.fixture(scope="module")
def explicit_x():
    """The solvated alanine minimized through the full system's sweep."""
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    setup = W.explicit_setup()
    x, _ = minimize_energy(setup.system, setup.positions, force_fn=setup.minimize_force_fn)
    return x.numpy()


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request, tmp_path_factory, explicit_x):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"remd{world}")
    return world, tmp, W.spawn("remd", world, tmp, tmp=str(tmp), explicit_x=explicit_x)


@pytest.fixture(scope="module")
def serial():
    system, x = W.alanine_system()
    remd = ReplicaExchange(system, x, RemdConfig(**W.ALANINE_REMD), device="cpu")
    first = remd.run(W.ALANINE_STEPS)
    return system, first, remd.run(2 * W.ALANINE_REMD["exchange_frequency"])


@pytest.fixture(scope="module")
def explicit_serial(explicit_x):
    return {nb: W.explicit_remd(explicit_x, nonbonded=nb).run(W.EXPLICIT_STEPS)
            for nb in ("cells", "dense")}


def _same_run(res, ref, atol=1e-4):
    assert res.positions.shape == ref.positions.shape
    np.testing.assert_array_equal(res.replica_ids, ref.replica_ids)
    np.testing.assert_array_equal(res.acceptance_matrix, ref.acceptance_matrix)
    assert res.exchange_attempts == ref.exchange_attempts
    np.testing.assert_allclose(res.positions, ref.positions, atol=atol, rtol=0)
    np.testing.assert_allclose(res.potential_energy, ref.potential_energy,
                               rtol=2e-3, atol=0.05)
    np.testing.assert_allclose(res.kinetic_temperature, ref.kinetic_temperature,
                               rtol=1e-4)
    np.testing.assert_array_equal(res.temperatures, ref.temperatures)


def test_sharded_alanine_remd_matches_serial(ranks, serial):
    world, _, res = ranks
    _, ref, _ = serial
    assert 0.0 < ref.mean_acceptance < 1.0
    for out in res:
        assert out["local_rungs"] == W.ALANINE_REMD["n_replicas"] // world
        assert out["device"] == "cpu"
        _same_run(out["alanine"], ref)
    # every rank returns the whole run, bit for bit the same
    for out in res[1:]:
        np.testing.assert_array_equal(out["alanine"].positions, res[0]["alanine"].positions)


def test_checkpoint_written_sharded_resumes_with_and_without_a_mesh(ranks, serial):
    world, tmp, res = ranks
    system, _, ref_next = serial
    path = tmp / f"ck{world}.npz"
    assert path.exists()
    for out in res:
        assert out["checkpoint_extra"] == {"world": world}
        assert out["resumed_local_rungs"] == W.ALANINE_REMD["n_replicas"] // world
        # the resumed mesh run continues the sharded run bit for bit
        np.testing.assert_array_equal(out["resumed_next"].positions, out["next"].positions)
        np.testing.assert_array_equal(out["resumed_next"].replica_ids, out["next"].replica_ids)
        _same_run(out["next"], ref_next)
    _same_run(res[0]["unsharded_resume"], ref_next)
    # the file is the one a serial run writes: all rungs, the swap counter
    remd, _, _ = load_checkpoint(path, system, device="cpu")
    assert remd.state.positions.shape == (8, system.n_atoms, 3)
    assert remd._attempts_done == W.ALANINE_STEPS // W.ALANINE_REMD["exchange_frequency"]
    with np.load(path) as data:
        assert data["positions"].shape == (8, system.n_atoms, 3)
        assert data["keys"].shape == (8, 2)


@pytest.mark.parametrize("nonbonded", ["cells", "dense"])
def test_sharded_explicit_remd_through_the_cell_path(ranks, explicit_serial, nonbonded):
    """Rows 9 (replica-batched) and 8 under the replica mesh."""
    _, _, res = ranks
    for out in res:
        _same_run(out["explicit"][nonbonded], explicit_serial[nonbonded])


def test_what_a_mesh_refuses(ranks):
    """JAX's refusals: a ladder that does not divide over the mesh, the
    fused kernel (``use_pallas`` in JAX), ``run_fused``; an object that
    is not a ``DeviceMesh``; and a force function split into x-slabs, whose
    sum over the ranks would add different rungs."""
    world, _, res = ranks
    for out in res:
        ref = out["refusals"]
        assert f"({4 * world + 1}) does not divide over the {world}-rank mesh" in ref[
            "indivisible"]
        assert ref["entry_indivisible"] == ref["indivisible"]
        assert ref["use_kernel"] == "use_kernel=True is single-chip only for now"
        assert ref["run_fused"] == "run_fused is single-chip; use run() with a mesh"
        assert "DeviceMesh" in ref["not_a_mesh"]
        assert "cannot run under a replica mesh" in ref["slab_force_fn"]


def test_entry_refuses_a_non_mesh_without_a_process_group():
    assert not torch.distributed.is_initialized()
    system, x = W.alanine_system()
    with pytest.raises(TypeError, match="DeviceMesh"):
        ReplicaExchange(system, x, RemdConfig(n_replicas=2), mesh=object(), minimize=False)
