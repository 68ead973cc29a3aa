"""Whole-run fused REMD (``ReplicaExchange.run_fused``, ``FusedChunk.remd``):
the swap stream, the swap phase against the ``_parity_matrices`` algebra of
``pmarlo_tpu/md/pallas_md.py build_pallas_remd`` in numpy, the plain version
against ``run()`` on the CPU, and the CUDA kernel against the windowed
kernel path on the card.

JAX is imported inside the tests that compare against it, so that the
``gpu`` tests also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_fused_remd.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from pmarlo_tpu_torch.data import alanine_dipeptide_structure, replicate_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.features import TopologyInfo, phi_psi_indices
from pmarlo_tpu_torch.md import fused_md
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
from pmarlo_tpu_torch.md.integrate import MDState, instantaneous_temperature
from pmarlo_tpu_torch.md.topology import build_topology
from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig, deeptica_from_numpy
from pmarlo_tpu_torch.remd.remd import (
    SWAP_KEY,
    RemdConfig,
    ReplicaExchange,
    swap_uniforms,
)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def alanine():
    system, pos = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")
    return system, pos


def _config(R=4, seed=5, **kw):
    base = dict(n_replicas=R, t_min=300.0, t_max=600.0, exchange_frequency=6,
                report_interval=3, seed=seed)
    base.update(kw)
    return RemdConfig(**base)


# --- the swap stream ---------------------------------------------------------------------

def _philox_python(counter, key):
    """Philox4x32-10 on Python integers (Random123's definition)."""
    c, k = list(counter), list(key)
    mask = 0xFFFFFFFF
    for rnd in range(10):
        if rnd:
            k = [(k[0] + 0x9E3779B9) & mask, (k[1] + 0xBB67AE85) & mask]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1], p0 & mask]
    return c


@pytest.mark.parametrize("seed,attempt", [(0, 0), (2024, 7), (123456789, 2**33 + 5)])
def test_swap_uniforms_are_philox_of_seed_attempt_pair(seed, attempt):
    """u[p] = ((w0 >> 8) + 1/2) / 2^24 of Philox with key (seed, SWAP_KEY) and
    counter (attempt low, attempt high, p, 1): the definition the fused
    REMD kernel implements."""
    R = 6
    u = swap_uniforms(seed, attempt, R, "cpu")
    assert u.shape == (R,) and u.dtype == torch.float32
    for p in range(R):
        w0 = _philox_python([attempt & 0xFFFFFFFF, attempt >> 32, p, 1],
                            [seed & 0x7FFFFFFF, SWAP_KEY])[0]
        # in float32, as the kernel computes it
        want = (np.float32(w0 >> 8) + np.float32(0.5)) * np.float32(1.0 / 16777216.0)
        assert float(u[p]) == float(want)
    assert bool(((u > 0.0) & (u < 1.0)).all())
    assert torch.equal(u, swap_uniforms(seed, attempt, R, "cpu"))
    assert not torch.equal(u, swap_uniforms(seed, attempt + 1, R, "cpu"))
    assert not torch.equal(u, swap_uniforms(seed + 1, attempt, R, "cpu"))
    # a longer ladder extends the stream: pair p keeps its number
    assert torch.equal(u, swap_uniforms(seed, attempt, R + 3, "cpu")[:R])


def test_swap_uniforms_are_uniform():
    u = torch.cat([swap_uniforms(11, a, 32, "cpu") for a in range(400)]).double()
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(u.var()) - 1.0 / 12.0) < 0.005
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


# --- the swap phase against the TPU kernel's matrix algebra -----------------------------------

@pytest.mark.parametrize("R", [4, 5, 8])
@pytest.mark.parametrize("parity", [0, 1])
def test_attempt_swaps_match_parity_matrix_algebra(alanine, R, parity):
    """``_attempt_swaps`` against ``build_pallas_remd``'s swap written out
    in numpy with ``_parity_matrices``: partner energies and betas by P,
    one uniform per pair by M_lo, T = (1 - a) I + a P applied to positions,
    velocities (scaled by sqrt(T_new / T_old)) and identities. Decisions
    identical; moved arrays equal."""
    pytest.importorskip("jax")
    from pmarlo_tpu.md.pallas_md import _parity_matrices

    system, pos = alanine
    rng = np.random.default_rng(100 * R + parity)
    remd = ReplicaExchange(system, pos, _config(R), device="cpu", minimize=False)
    ladder = remd.ladder.numpy().astype(np.float32)
    N = system.n_atoms
    x = rng.normal(0.0, 1.0, (R, N, 3)).astype(np.float32)
    v = rng.normal(0.0, 1.0, (R, N, 3)).astype(np.float32)
    # energies spread so that both accepted and refused pairs occur
    E = rng.normal(0.0, 8.0, R).astype(np.float32)
    u = rng.uniform(0.01, 0.99, R).astype(np.float32)
    ids = rng.permutation(R).astype(np.int32)
    seeds = rng.integers(0, 2**31 - 1, R).astype(np.int32)

    P, paired, Mlo = _parity_matrices(R)[parity]
    beta = (1.0 / (BOLTZMANN_CONSTANT_KJ_PER_MOL * ladder)).astype(np.float32)
    log_acc = (beta - P @ beta) * (E - P @ E)
    accept = (np.log(Mlo @ u) < log_acc).astype(np.float32) * paired[:, 0]
    T = np.eye(R, dtype=np.float32) * (1.0 - accept[:, None]) + P * accept[:, None]
    scale = np.sqrt(ladder / (T @ ladder))
    want_x = np.einsum("rq,qnc->rnc", T, x)
    want_v = np.einsum("rq,qnc->rnc", T, v) * scale[:, None, None]
    want_ids = (T @ ids.astype(np.float32)).astype(np.int32)

    state = MDState(positions=torch.as_tensor(x), velocities=torch.as_tensor(v),
                    seeds=torch.as_tensor(seeds), step=0)
    new, new_ids, acc_left = remd._attempt_swaps(
        state, torch.as_tensor(E), torch.as_tensor(ids), parity, torch.as_tensor(u))
    np.testing.assert_array_equal(new.positions.numpy(), want_x)
    np.testing.assert_allclose(new.velocities.numpy(), want_v, rtol=1e-6)
    np.testing.assert_array_equal(new_ids.numpy(), want_ids)
    np.testing.assert_array_equal(new.seeds.numpy(), (T @ seeds.astype(np.float64)).astype(np.int32))
    # acc_left: the decision on each attempted left rung, NaN elsewhere
    left = np.nan_to_num(acc_left.numpy(), nan=0.0)
    np.testing.assert_array_equal(left + np.roll(left, 1), accept)
    is_left = (np.arange(R) % 2 == parity) & (np.arange(R) + 1 < R)
    assert np.array_equal(np.isfinite(acc_left.numpy()), is_left)


# --- the plain version of the whole run --------------------------------------------------------

def test_run_fused_twin_matches_run_on_the_cpu(alanine):
    """Same start and seeds through ``run_fused`` (plain version) and
    ``run``: identical ``ids_hist``, frames, energies, acceptance, state
    and seeds; both carry on alike in a second call."""
    system, pos = alanine
    cfg = _config(4)
    a = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False)
    b = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False)
    before = dict(fused_md.variant_launches)
    for n_steps in (24, 12):
        rf, rw = a.run_fused(n_steps), b.run(n_steps)
        np.testing.assert_array_equal(rf.replica_ids, rw.replica_ids)
        np.testing.assert_array_equal(rf.positions, rw.positions)
        np.testing.assert_array_equal(rf.potential_energy, rw.potential_energy)
        np.testing.assert_allclose(rf.acceptance_matrix, rw.acceptance_matrix, equal_nan=True)
        np.testing.assert_allclose(rf.kinetic_temperature, rw.kinetic_temperature, rtol=1e-5)
        assert torch.equal(a.state.positions, b.state.positions)
        assert torch.equal(a.state.velocities, b.state.velocities)
        assert torch.equal(a.state.seeds, b.state.seeds)
        assert torch.equal(a.replica_ids, b.replica_ids)
        assert a.state.step == b.state.step and a._attempts_done == b._attempts_done
    assert a.state.step == 36 and a._attempts_done == 6
    assert fused_md.variant_launches == before
    # swaps happened, and the identities of the second call start where
    # the first ended
    assert (rf.replica_ids[0] != np.arange(4)).any()


def test_run_fused_result_fields(alanine):
    system, pos = alanine
    cfg = _config(5, exchange_frequency=4, report_interval=2)
    remd = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False)
    res = remd.run_fused(16)
    A, fpc, R, N = 4, 2, 5, system.n_atoms
    assert res.positions.shape == (A * fpc, R, N, 3)
    assert res.potential_energy.shape == (A * fpc, R)
    assert res.replica_ids.shape == (A + 1, R)
    assert res.exchange_attempts == A and res.frames_per_attempt == fpc
    assert res.n_steps == 16 and res.dt_ps == cfg.dt_ps
    assert res.acceptance_matrix.shape == (R - 1,)
    for row in res.replica_ids:
        assert sorted(row.tolist()) == list(range(R))
    np.testing.assert_array_equal(res.replica_ids[0], np.arange(R))
    # pair p is attempted on the windows whose parity makes p a left rung
    ids = res.replica_ids
    for p in range(R - 1):
        swapped = [ids[a + 1, p] != ids[a, p] for a in range(p % 2, A, 2)]
        assert res.acceptance_matrix[p] == pytest.approx(np.mean(swapped))
    # the kinetic temperature is that of the state velocities at the frame
    t_last = instantaneous_temperature(system, remd.state.velocities)
    # (the last frame precedes the closing swap, which rescales velocities)
    assert res.kinetic_temperature.shape == (A * fpc, R)
    assert np.isfinite(res.kinetic_temperature).all() and bool(torch.isfinite(t_last).all())
    assert res.wall_seconds > 0.0


def test_run_fused_i16_frames_are_quantized(alanine):
    system, pos = alanine
    cfg = _config(2, frame_precision="i16")
    a = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False)
    b = ReplicaExchange(system, pos, dataclasses.replace(cfg, frame_precision="f32"),
                        device="cpu", minimize=False)
    qa, fb = a.run_fused(6).positions, b.run_fused(6).positions
    assert np.abs(qa - fb).max() <= 5.01e-4
    np.testing.assert_allclose(qa * 1000.0, np.round(qa * 1000.0), atol=1e-3)


def test_run_fused_refuses_what_it_cannot_run(alanine):
    system, pos = alanine
    cfg = _config(2)
    biased = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False,
                             bias_fn=lambda x: x.pow(2).sum((-1, -2)))
    with pytest.raises(ValueError, match="in-kernel bias only"):
        biased.run_fused(6)
    from pmarlo_tpu_torch.md.integrate import make_force_fn

    override = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False,
                               force_fn=make_force_fn(system))
    with pytest.raises(ValueError, match="fused chunk"):
        override.run_fused(6)
    plain = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False)
    for n_steps in (0, 3, 7):
        with pytest.raises(ValueError, match="multiple of"):
            plain.run_fused(n_steps)
    with pytest.raises(ValueError, match="kernel_bias requires use_kernel"):
        ReplicaExchange(system, pos, cfg, device="cpu", minimize=False,
                        kernel_bias={"model": None, "quads": None})
    with pytest.raises(ValueError, match="kernel_bias"):
        ReplicaExchange(system, pos, cfg, device="cpu", minimize=False, use_kernel=True,
                        bias_fn=lambda x: x.pow(2).sum((-1, -2)))


def _tiny_model(n_dihedrals, device="cpu", hidden=(8,)):
    rng = np.random.default_rng(0)
    k = 2 * n_dihedrals
    sizes = [k, *hidden, 2]
    params = [{"w": rng.normal(0.0, 0.7, (a, b)).astype(np.float32),
               "b": rng.normal(0.0, 0.1, b).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    return deeptica_from_numpy(DeepTICAConfig(hidden=tuple(hidden), n_out=2), params,
                               np.zeros(k, np.float32), np.ones(k, np.float32), device=device)


def _quads(structure):
    info = TopologyInfo.from_topology(build_topology(structure))
    phi, psi, _ = phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    return np.concatenate([phi, psi], 0)


def test_run_fused_runs_the_chunk_it_was_built_with(alanine):
    """``run`` and ``run_fused`` share one chunk, so a biased construction
    cannot come out unbiased from ``run_fused``: with the bias in the
    chunk the fused twin's frame energies carry it and its trajectory
    leaves the unbiased one."""
    system, pos = alanine
    quads = _quads(alanine_dipeptide_structure())
    cfg = _config(2)
    free = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False)
    biased = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False)
    biased._chunk = build_fused_chunk(
        system, dt=cfg.dt_ps, friction=cfg.friction_per_ps, n_replicas=2,
        bias_model=_tiny_model(len(quads)), bias_quads=quads, bias_strength=50.0)
    rf, rb = free.run_fused(12), biased.run_fused(12)
    assert np.abs(rf.positions - rb.positions).max() > 1e-5
    x_last = torch.as_tensor(rb.positions[-1])
    e_bias, _ = biased._chunk.bias.energy_and_forces(x_last)
    e_phys, _ = free._chunk.energy_and_forces(x_last)
    np.testing.assert_allclose(rb.potential_energy[-1], (e_phys + e_bias).numpy(), rtol=1e-5,
                               atol=1e-4)
    assert float(e_bias.abs().max()) > 1e-3


def test_run_fused_on_a_cuda_device_launches_whatever_use_kernel_says(alanine):
    """A CUDA device sends ``run_fused`` to ``FusedChunk.remd`` (the launch
    happens or the call raises), as JAX's ``run_fused`` always builds
    ``build_pallas_remd``; the constructor's default ``use_kernel=False``
    must not route the card to the plain version."""
    system, pos = alanine
    remd = ReplicaExchange(system, pos, _config(2), device="cpu", minimize=False)
    assert remd.use_kernel is False

    class Launched(Exception):
        pass

    def fake_remd(*args, **kwargs):
        raise Launched

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA device")

    remd._chunk.remd = fake_remd
    remd._run_fused_reference = no_plain
    remd.device = torch.device("cuda")
    with pytest.raises(Launched):
        remd.run_fused(6)


def test_run_fused_reference_leaves_the_state_alone(alanine):
    system, pos = alanine
    remd = ReplicaExchange(system, pos, _config(3), device="cpu", minimize=False)
    x0, ids0 = remd.state.positions.clone(), remd.replica_ids.clone()
    out = remd._run_fused_reference(2, 2)
    assert torch.equal(remd.state.positions, x0) and torch.equal(remd.replica_ids, ids0)
    assert remd.state.step == 0 and remd._attempts_done == 0
    res = remd.run_fused(12)
    np.testing.assert_array_equal(res.positions, out.frames.numpy())
    np.testing.assert_array_equal(res.replica_ids, out.ids_hist.numpy())


# --- the kernel on the card ------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("biased", [False, True], ids=["unbiased", "kernel_bias"])
@pytest.mark.parametrize("molecule,R", [("alanine", 8), ("alanine", 5), ("chignolin", 32)])
def test_fused_remd_kernel_matches_the_windowed_kernel_path(molecule, R, biased):
    """``run_fused`` (one launch) against ``run(use_kernel=True)`` (one
    launch a frame) from the same start and seeds: ``ids_hist`` and
    acceptance equal, frames to 1e-3 nm, energies to 1e-4, and again in a
    second call that continues the first."""
    _need_card()
    structure = alanine_dipeptide_structure() if molecule == "alanine" else chignolin_structure()
    system, pos = build_system(structure, gb_model="gbn2", device="cuda")
    quads = _quads(structure)
    kb = ({"model": _tiny_model(len(quads), "cuda", hidden=(64, 64)), "quads": quads,
           "strength": 2.0} if biased else None)
    cfg = RemdConfig(n_replicas=R, t_min=300.0, t_max=450.0, exchange_frequency=20,
                     report_interval=10, seed=4)
    a = ReplicaExchange(system, pos, cfg, device="cuda", use_kernel=True, kernel_bias=kb,
                        minimize=False)
    b = ReplicaExchange(system, pos, cfg, device="cuda", use_kernel=True, kernel_bias=kb,
                        minimize=False)
    for n_steps in (200, 100):
        before = fused_md.variant_launches["fused_remd"]
        rf = a.run_fused(n_steps)
        torch.cuda.synchronize()
        assert fused_md.variant_launches["fused_remd"] == before + 1
        rw = b.run(n_steps)
        np.testing.assert_array_equal(rf.replica_ids, rw.replica_ids)
        np.testing.assert_allclose(rf.acceptance_matrix, rw.acceptance_matrix, equal_nan=True)
        assert np.abs(rf.positions - rw.positions).max() <= 1e-3
        assert (np.abs(rf.potential_energy - rw.potential_energy).max()
                <= 1e-4 * np.abs(rw.potential_energy).max())
        np.testing.assert_allclose(rf.kinetic_temperature, rw.kinetic_temperature, rtol=1e-3)
        assert float((a.state.positions - b.state.positions).abs().max()) <= 1e-3
        assert float((a.state.velocities - b.state.velocities).abs().max()) <= 1e-2
        assert torch.equal(a.state.seeds, b.state.seeds)
        assert torch.equal(a.replica_ids, b.replica_ids)
    assert (rf.replica_ids[-1] != np.arange(R)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("biased", [False, True], ids=["unbiased", "kernel_bias"])
def test_fused_remd_kernel_matches_its_plain_version(biased):
    """``run_fused`` on the card (the kernel, although ``use_kernel`` is
    left at its default for the unbiased case) against
    ``_run_fused_reference`` from the same state over 3 windows with swaps:
    ``ids_hist`` equal, frames to 1e-3 nm, energies to 1e-4, final
    velocities (rescaled by the swaps) to 1e-2 nm/ps."""
    _need_card()
    structure = alanine_dipeptide_structure()
    system, pos = build_system(structure, gb_model="gbn2", device="cuda")
    quads = _quads(structure)
    kb = ({"model": _tiny_model(len(quads), "cuda", hidden=(64, 64)), "quads": quads,
           "strength": 2.0} if biased else None)
    cfg = RemdConfig(n_replicas=8, t_min=300.0, t_max=450.0, exchange_frequency=20,
                     report_interval=10, seed=4)
    remd = ReplicaExchange(system, pos, cfg, device="cuda", use_kernel=biased,
                           kernel_bias=kb, minimize=False)
    ref = remd._run_fused_reference(3, 2)
    before = fused_md.variant_launches["fused_remd"]
    res = remd.run_fused(60)
    torch.cuda.synchronize()
    assert fused_md.variant_launches["fused_remd"] == before + 1
    np.testing.assert_array_equal(res.replica_ids, ref.ids_hist.cpu().numpy())
    assert (res.replica_ids[-1] != res.replica_ids[0]).any()
    assert np.abs(res.positions - ref.frames.cpu().numpy()).max() <= 1e-3
    e_ref = ref.frame_energy.cpu().numpy()
    assert np.abs(res.potential_energy - e_ref).max() <= 1e-4 * np.abs(e_ref).max()
    assert float((remd.state.velocities - ref.velocities).abs().max()) <= 1e-2
    assert torch.equal(remd.state.seeds, ref.seeds)


@pytest.mark.gpu
def test_fused_remd_raises_when_the_replicas_cannot_all_be_resident():
    """The grid barrier needs every CTA on the card at once: with more
    replicas of 506 atoms than any launch shape holds resident (the card's
    own count, asked for every shape), ``run_fused`` raises instead of
    running in pieces."""
    _need_card()
    structure = replicate_structure(alanine_dipeptide_structure(), (23, 1, 1))
    system, pos = build_system(structure, gb_model="gbn2", device="cuda")
    probe = fused_md.FusedChunk(system, dt=0.002, friction=1.0, n_replicas=1)
    ints = probe._common_args(1, 0)[1]
    R = 8 + max(min(probe._plan_of(m, ints, s)["resident"] for m in (0, 2))
                for s in fused_md.launch_shapes(system.n_atoms))
    cfg = RemdConfig(n_replicas=R, t_min=300.0, t_max=450.0, exchange_frequency=2,
                     report_interval=2, seed=0)
    remd = ReplicaExchange(system, pos, cfg, device="cuda", use_kernel=True, minimize=False)
    with pytest.raises(RuntimeError, match="resident"):
        remd.run_fused(2)
    # the windowed path has no barrier and runs
    assert np.isfinite(remd.run(2).positions).all()
