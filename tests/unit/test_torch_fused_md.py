"""The fused Langevin chunk (``pmarlo_tpu_torch/md/fused_md.py``): its plain
twin against the JAX integrator, general torsions, the noise stream, and the
CUDA kernel against the twin on the card.

JAX is imported inside the tests that compare against it, so that the
``gpu`` test also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_fused_md.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure, replicate_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.md import analytic, fused_md
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.forces import energy_and_forces_autograd
from pmarlo_tpu_torch.md.fused_md import (
    MAX_ATOMS, MAX_CLUSTER, MAX_THREADS, FusedChunk, LaunchShape, _bonded_csr,
    build_fused_chunk, launch_shape, launch_shapes)
from pmarlo_tpu_torch.md.integrate import gaussian_noise, philox4x32_10

DT = 0.002


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(R, device="cpu", seed=0, sigma=0.005, copies=(1, 1, 1), structure=None):
    """Alanine GBn2 positions near the crystal geometry (``copies`` tiles
    the molecule on a grid; or another ``structure``) and 300-450 K
    Maxwell-Boltzmann velocities, made with numpy from ``seed``."""
    if structure is None:
        structure = replicate_structure(alanine_dipeptide_structure(), copies)
    system, pos = build_system(structure, gb_model="gbn2", device=device)
    n = system.n_atoms
    rng = np.random.default_rng(seed)
    x = pos.cpu().numpy()[None] + rng.normal(0.0, sigma, (R, n, 3))
    temps = np.linspace(300.0, 450.0, R)
    m = system.masses.cpu().numpy()
    v = np.sqrt(0.00831446261815324 * temps[:, None, None] / m[None, :, None]) \
        * rng.standard_normal((R, n, 3))
    seeds = rng.integers(0, 2**31 - 1, R)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return system, t(x), t(v), t(seeds, torch.int32), t(temps)


def test_chunk_reference_matches_jax_langevin_at_friction_0():
    """100 steps at friction 0 (velocity Verlet): the twin against JAX
    ``langevin_step`` in a scan, from the same numpy positions and
    velocities. Both run float32 on the CPU; the trajectories agree to
    1e-4 nm and 1e-3 nm/ps (rounding grown over 100 steps)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu.md.integrate import MDState, langevin_step, make_force_fn

    R, n_steps = 2, 100
    system, x, v, seeds, temps = _inputs(R)
    chunk = build_fused_chunk(system, dt=DT, friction=0.0, n_replicas=R)
    xt, vt, et = chunk.reference(x, v, seeds, temps, n_steps, 0)

    js, _ = jax_build_system(jax_alanine(), gb_model="gbn2")
    force_fn = make_force_fn(js, analytic=True)

    def step(st, _):
        def one(s, T):
            return langevin_step(js, s, dt=DT, friction=0.0, temperature_K=T,
                                 force_fn=force_fn)
        return jax.vmap(one)(st, jnp.asarray(temps.numpy()))

    st = MDState(
        positions=jnp.asarray(x.numpy()), velocities=jnp.asarray(v.numpy()),
        key=jax.random.split(jax.random.PRNGKey(0), R),
        step=jnp.zeros(R, jnp.int32),
    )
    st, _ = jax.jit(lambda s: jax.lax.scan(step, s, None, length=n_steps))(st)
    je = jax.vmap(lambda y: force_fn(y)[0])(st.positions)
    np.testing.assert_allclose(xt.numpy(), np.asarray(st.positions), atol=1e-4, rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(st.velocities), atol=1e-3, rtol=0)
    np.testing.assert_allclose(et.numpy(), np.asarray(je), rtol=1e-4)


def test_general_torsions_match_autograd():
    """Periodicity 6 and phase pi/3 on every torsion: the analytic forces
    (the kernel's math) are the gradient of the autograd energy (1e-4
    relative, float32)."""
    system, x, _, _, _ = _inputs(3)
    nt = system.torsion_n.shape[0]
    system = dataclasses.replace(
        system,
        torsion_n=torch.full((nt,), 6.0),
        torsion_phase=torch.full((nt,), math.pi / 3),
    )
    e, f = analytic.energy_and_forces(analytic.make_dense_params(system), x)
    ae, af = energy_and_forces_autograd(system, x)
    assert float((e - ae).abs().max() / ae.abs().max()) <= 1e-4
    assert float((f - af).abs().max() / af.abs().max()) <= 1e-4


def test_philox_known_answers():
    """Random123's published Philox4x32-10 test vectors."""
    def run(c, k):
        t = [torch.tensor([w], dtype=torch.int64) for w in c + k]
        return [int(w) for w in philox4x32_10(*t)]

    assert run([0] * 4, [0] * 2) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
               [0xA4093822, 0x299F31D0]) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_gaussian_noise_is_standard_normal_and_keyed():
    seeds = torch.tensor([5, 5, 9], dtype=torch.int32)
    z = torch.stack([gaussian_noise(seeds, s, 22) for s in range(300)])
    assert z.shape == (300, 3, 22, 3)
    flat = z.reshape(-1).double()
    # 59,400 draws: mean within 5 standard errors, variance within 2%
    assert abs(float(flat.mean())) < 5.0 / math.sqrt(flat.numel())
    assert abs(float(flat.var()) - 1.0) < 0.02
    # replicas with one seed differ (the replica index is in the key);
    # the stream is a pure function of (seed, replica, step, atom)
    assert not torch.equal(z[:, 0], z[:, 1])
    assert torch.equal(z[7], gaussian_noise(seeds, 7, 22))
    assert not torch.equal(z[7], z[8])


def test_step_offset_continues_the_stream():
    """Two 10-step chunks with successive offsets equal one 20-step chunk;
    repeating an offset repeats the noise."""
    R = 2
    system, x, v, seeds, temps = _inputs(R)
    chunk = build_fused_chunk(system, dt=DT, friction=1.0, n_replicas=R)
    x1, v1, _ = chunk(x, v, seeds, temps, 10, 0)
    x2, v2, e2 = chunk(x1, v1, seeds, temps, 10, 10)
    x20, v20, e20 = chunk(x, v, seeds, temps, 20, 0)
    torch.testing.assert_close(x2, x20, rtol=0, atol=0)
    torch.testing.assert_close(v2, v20, rtol=0, atol=0)
    x1b, _, _ = chunk(x, v, seeds, temps, 10, 0)
    assert torch.equal(x1, x1b)
    x1c, _, _ = chunk(x, v, seeds, temps, 10, 10)
    assert not torch.equal(x1, x1c)


def test_cpu_tensors_run_the_plain_twin_without_launching():
    R = 2
    system, x, v, seeds, temps = _inputs(R)
    chunk = build_fused_chunk(system, dt=DT, friction=1.0, n_replicas=R)
    before = fused_md.launches
    out = chunk(x, v, seeds, temps, 5, 3)
    ref = chunk.reference(x, v, seeds, temps, 5, 3)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    e, f = chunk.energy_and_forces(x)
    ea, fa = analytic.energy_and_forces(chunk.dense, x)
    assert torch.equal(e, ea) and torch.equal(f, fa)
    assert fused_md.launches == before
    with pytest.raises(RuntimeError, match="CUDA"):
        chunk._launch(x, v, seeds, temps, 5, 0, False)


def test_chunk_validates_its_inputs():
    R = 2
    system, x, v, seeds, temps = _inputs(R)
    chunk = build_fused_chunk(system, dt=DT, friction=1.0, n_replicas=R)
    with pytest.raises(ValueError, match="must match"):
        chunk(x, v[:, :5], seeds, temps, 1, 0)
    with pytest.raises(TypeError, match="int32"):
        chunk(x, v, seeds.long(), temps, 1, 0)
    with pytest.raises(ValueError, match=r"\(R,\)"):
        chunk(x, v, seeds[:1], temps, 1, 0)


def test_chunk_refuses_systems_above_the_kernel_bound():
    """Many replicas fall back to one CTA a replica and one thread an atom,
    so above MAX_ATOMS the chunk raises when it is built, on any device."""
    system, _, _, _, _ = _inputs(1, copies=(24, 1, 1))
    assert system.n_atoms == 528 > MAX_ATOMS
    with pytest.raises(ValueError, match=f"exceeds {MAX_ATOMS}"):
        FusedChunk(system, dt=DT, friction=1.0, n_replicas=1)


def test_bonded_csr_lists_every_term_role_once():
    system, _, _, _, _ = _inputs(1)
    ptr, ent = _bonded_csr(system)
    assert ptr[0] == 0 and ptr[-1] == len(ent)
    seen = set()
    for atom in range(system.n_atoms):
        for code, term in ent[ptr[atom]:ptr[atom + 1]]:
            ttype, role = code >> 2, code & 3
            idx = (system.bond_idx, system.angle_idx, system.torsion_idx)[ttype]
            assert int(idx[term, role]) == atom
            seen.add((ttype, role, int(term)))
    n_roles = sum(int(t.numel()) for t in
                  (system.bond_idx, system.angle_idx, system.torsion_idx))
    assert len(seen) == n_roles == len(ent)


# --- the launch shape ------------------------------------------------------------------------

H100_SMS = 132


def _h100_capacity(n_atoms, ctas_per_sm):
    """A stand-in for the card's count of resident replicas of a shape
    (occupancy and ``cudaOccupancyMaxActiveClusters``, which the wrapper
    asks on the card): an SM holds ``ctas_per_sm`` CTAs of ``MAX_THREADS``
    threads and proportionally more of fewer threads, at most 32, and a
    cluster's CTAs share one GPC, counted as one GPC of 14 SMs for every
    16 (an H100 SXM's 132 SMs sit in 8 GPCs of 14-18)."""
    def capacity(shape):
        per_sm = min(32, (ctas_per_sm * MAX_THREADS) // shape.threads(n_atoms))
        if shape.cluster == 1:
            return H100_SMS * per_sm
        return (H100_SMS // 16) * ((14 * per_sm) // shape.cluster)
    return capacity


def _old_capacity(n_atoms, n_sms, ctas_per_sm):
    """Replicas the one-thread-an-atom design before the row teams took at
    once: one CTA of the next power of two >= max(N, 32) threads a
    replica."""
    threads = 32
    while threads < n_atoms:
        threads *= 2
    return n_sms * min(32, (ctas_per_sm * MAX_THREADS) // threads)


@pytest.mark.parametrize("ctas_per_sm", [1, 2])
@pytest.mark.parametrize("R", [1, 8, 32, 33, 132, 512])
def test_launch_shape_is_a_valid_layout_for_every_atom_count(R, ctas_per_sm):
    """For N = 1..512 on the H100's 132 SMs: at most 512 threads, L a power
    of two within a warp, C in 1, 2, 4, 8, every row owned by exactly one
    team of one CTA; all R replicas resident at once unless the shape is
    the one-thread-an-atom fallback, and never a refusal of a replica
    count the one-thread-an-atom design launched."""
    for n in range(1, MAX_ATOMS + 1):
        capacity = _h100_capacity(n, ctas_per_sm)
        s = launch_shape(n, R, capacity)
        rows, threads = s.rows(n), s.threads(n)
        assert threads <= MAX_THREADS and threads % 32 == 0
        assert s.lanes in (1, 2, 4, 8, 16, 32)
        assert s.cluster in (1, 2, 4, 8) and s.cluster <= MAX_CLUSTER
        assert rows == -(-n // s.cluster) and rows * s.lanes <= threads < rows * s.lanes + 32
        owner = np.full(n, -1)
        for k in range(s.cluster):
            mine = np.arange(k * rows, min(n, (k + 1) * rows))
            assert mine.size >= 1, (n, R, s)          # no CTA without rows
            assert (owner[mine] == -1).all()
            owner[mine] = k
        assert (owner >= 0).all()
        cap = capacity(s)
        assert R <= cap or s == LaunchShape(1, 1), (n, R, s, cap)
        if R <= _old_capacity(n, H100_SMS, ctas_per_sm):
            assert R <= cap, (n, R, s, cap)


def test_launch_shape_fills_the_card_with_teams_and_lowers_clusters_on_request():
    """The shapes of the paths (R=32): alanine one CTA of 16-lane atom teams
    and 2-lane pair teams, 138-atom chignolin eight CTAs of 8-lane atom
    teams (four of 288 threads do not all fit the H100's GPCs at one CTA an
    SM); where the card holds no clusters beyond 4 or 1 CTAs, fewer CTAs;
    many replicas drop the lanes first. ``launch_shapes`` lists every
    layout the kernels take."""
    h100 = {n: _h100_capacity(n, 1) for n in (22, 138, 506)}

    def at_most(n, c):
        return lambda s: h100[n](s) if s.cluster <= c else 0

    assert launch_shape(22, 32, h100[22]) == LaunchShape(1, 16, 2, 1)
    assert launch_shape(138, 32, h100[138]) == LaunchShape(8, 8, 4, 2)
    assert launch_shape(138, 8, h100[138]) == LaunchShape(8, 16, 16, 2)
    assert launch_shape(138, 32, at_most(138, 4)) == LaunchShape(2, 4, 8, 2)
    assert launch_shape(138, 32, at_most(138, 1)) == LaunchShape(1, 2, 16, 2)
    assert launch_shape(22, 512, h100[22]) == LaunchShape(1, 4, 8, 2)
    assert launch_shape(506, 512, h100[506]) == LaunchShape(1, 1)
    assert launch_shape(138, 1, lambda s: 0) == LaunchShape(1, 1)
    assert LaunchShape(8, 8).threads(138) == 160 and LaunchShape(2, 4).rows(138) == 69
    assert LaunchShape(8, 16) in launch_shapes(138)
    assert LaunchShape(8, 1) not in launch_shapes(7)           # a CTA without rows
    assert LaunchShape(1, 32) not in launch_shapes(22)         # 704 threads
    with pytest.raises(ValueError):
        launch_shape(MAX_ATOMS + 1, 1, h100[506])


# --- the kernel on the card ---------------------------------------------------------------------

MOLECULES = {
    "22_atoms": dict(copies=(1, 1, 1)),
    "138_atoms": dict(structure="chignolin"),
    "176_atoms": dict(copies=(2, 2, 2)),
    "506_atoms": dict(copies=(23, 1, 1)),
}


def _card_inputs(name, R, seed=0):
    kw = dict(MOLECULES[name])
    if kw.get("structure") == "chignolin":
        kw["structure"] = chignolin_structure()
    return _inputs(R, device="cuda", seed=seed, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 8, 33])
@pytest.mark.parametrize("copies", list(MOLECULES))
def test_kernel_matches_plain_twin_on_the_card(copies, R):
    """The CUDA kernel against its plain twin on the same card tensors:
    forces and energies to 1e-4 relative, 100 steps at friction 0 and at
    1/ps (same Philox stream) to 1e-3 nm, and a second launch bitwise equal
    to the first. The shapes chosen here span one CTA of 16-lane teams
    (22 atoms), clusters of 2-8 CTAs with 4-16 lanes, and the
    one-thread-an-atom layout; 22, 138 and 506 atoms are no multiple of
    the C x L chosen for them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    system, x, v, seeds, temps = _card_inputs(copies, R)
    assert system.n_atoms <= MAX_ATOMS
    for friction in (0.0, 1.0):
        chunk = build_fused_chunk(system, dt=DT, friction=friction, n_replicas=R)
        before = fused_md.launches
        ek, fk = chunk.energy_and_forces(x)
        ep, fp = analytic.energy_and_forces(chunk.dense, x)
        assert float((fk - fp).abs().max() / fp.abs().max()) <= 1e-4
        assert float((ek - ep).abs().max() / ep.abs().max()) <= 1e-4
        xk, vk, ek = chunk(x, v, seeds, temps, 100, 0)
        xk2, vk2, ek2 = chunk(x, v, seeds, temps, 100, 0)
        xp, vp, _ = chunk.reference(x, v, seeds, temps, 100, 0)
        torch.cuda.synchronize()
        assert fused_md.launches == before + 3
        assert torch.equal(xk, xk2) and torch.equal(vk, vk2) and torch.equal(ek, ek2)
        assert bool(torch.isfinite(xk).all())
        assert float((xk - xp).abs().max()) <= 1e-3
        e_at, _ = analytic.energy_and_forces(chunk.dense, xk)
        assert float((ek - e_at).abs().max() / e_at.abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("copies", ["22_atoms", "138_atoms"])
def test_every_launch_shape_matches_plain_twin_on_the_card(copies):
    """Every shape the kernel takes (C in 1, 2, 4, 8 and L up to 32 within
    512 threads) at R=8: forces to 1e-4 relative of the plain twin, 20
    steps to 1e-3 nm, reproducible bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    R = 8
    system, x, v, seeds, temps = _card_inputs(copies, R)
    n = system.n_atoms
    chunk = build_fused_chunk(system, dt=DT, friction=1.0, n_replicas=R)
    ep, fp = analytic.energy_and_forces(chunk.dense, x)
    xp, _, _ = chunk.reference(x, v, seeds, temps, 20, 0)
    zeros = torch.zeros(R, dtype=torch.int32, device="cuda")
    shapes = launch_shapes(n)
    for shape in shapes:
        _, _, ek, fk, _ = chunk._launch(x, torch.zeros_like(x), zeros, temps, 0, 0, True,
                                        shape=shape)
        xa, _, ea, _, _ = chunk._launch(x, v, seeds, temps, 20, 0, False, shape=shape)
        xb, _, eb, _, _ = chunk._launch(x, v, seeds, temps, 20, 0, False, shape=shape)
        torch.cuda.synchronize()
        assert chunk.last_launch["cluster"] == shape.cluster
        assert chunk.last_launch["lanes"] == shape.lanes
        assert chunk.last_launch["threads"] == shape.threads(n)
        assert float((fk - fp).abs().max() / fp.abs().max()) <= 1e-4, shape
        assert float((ek - ep).abs().max() / ep.abs().max()) <= 1e-4, shape
        assert float((xa - xp).abs().max()) <= 1e-3, shape
        assert torch.equal(xa, xb) and torch.equal(ea, eb), shape
    assert len(shapes) >= 14
