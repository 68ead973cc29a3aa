"""The fused kernels' pair walk (``csrc/fused_md.cu``, ``md/fused_md.py``):
each unordered pair once inside a replica, in items of a team of T lanes
whose column sums travel one lane a step, slots added in a fixed order; the
chooser of (C, L, T, P) under register-limited capacity models; the items'
tables against the dense tables; a plain replay of the walk's arithmetic
against the analytic forces and JAX's; ``run_fused``'s frame energy as the
evaluation the next step uses. On the card: both whole-run REMD kernels
against ``_run_fused_reference`` and against the windowed kernel path at
every width the plan can take.

JAX is imported inside the tests that compare against it, so that the
``gpu`` tests also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_fused_remd_redesign.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.features import TopologyInfo, phi_psi_indices
from pmarlo_tpu_torch.md import analytic, fused_md
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.fused_md import (
    MAX_ATOMS, MAX_THREADS, PAIR_TABS, LaunchShape, build_fused_chunk,
    launch_shape, launch_shapes, pair_items, shape_cost)
from pmarlo_tpu_torch.md.topology import build_topology
from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig, deeptica_from_numpy
from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

TEAMS = (2, 4, 8, 16, 32)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _walk(n, team):
    """The kernel's walk of ``pair_items(n, team)`` replayed on the host:
    for every item, lane and step, the row atom, the column atom, whether
    the lane takes the pair, and the lane that holds the pair's column sum
    when the item ends (the column sums move one lane down after each
    step). Arrays (items, S, T)."""
    items = pair_items(n, team).astype(np.int64)
    T, S = team, team // 2
    lane = np.arange(T)[None, None, :]
    step = np.arange(S)[None, :, None]
    k0 = (items[:, 2] & 0xFFFF)[:, None, None]
    diag = (items[:, 2] >> 16).astype(bool)[:, None, None]
    kk = k0 + step
    i = items[:, 0, None, None] + lane + 0 * step
    j = items[:, 1, None, None] + (lane + kk) % T
    ok = (i < n) & (j < n) & (~diag | (kk < T // 2) | (lane < T // 2))
    holder = (lane - S + step) % T                 # after S - step more moves
    held_col = items[:, 1, None, None] + (holder + k0 + S) % T
    return items, i, j, ok, held_col


@pytest.mark.parametrize("team", TEAMS)
def test_every_unordered_pair_is_met_once_and_every_slot_written_once(team):
    """For N = 1..512: the items meet each unordered pair exactly once and
    no atom itself; each column sum arrives at the lane whose final column
    is the pair's column atom; every atom of a group has slots 0..2G-1,
    each written by exactly one item side, so its owner adds them in one
    fixed order. ``pair_items`` is a pure function of (N, T)."""
    for n in range(1, MAX_ATOMS + 1):
        items, i, j, ok, held_col = _walk(n, team)
        G = -(-n // team)
        assert items.shape == (G * G, 4)
        assert not (ok & (i == j)).any(), n
        lo, hi = np.minimum(i, j)[ok], np.maximum(i, j)[ok]
        counts = np.bincount(lo * n + hi, minlength=n * n).reshape(n, n)
        assert (counts[np.triu_indices(n, 1)] == 1).all(), n
        assert counts.sum() == n * (n - 1) // 2
        assert (held_col[ok] == j[ok]).all(), n
        g, h = items[:, 0] // team, items[:, 1] // team
        sides = np.concatenate([np.stack([g, items[:, 3] & 0xFFFF], 1),
                                np.stack([h, items[:, 3] >> 16], 1)])
        for grp in range(G):
            assert sorted(sides[sides[:, 0] == grp, 1]) == list(range(2 * G)), (n, grp)
    np.testing.assert_array_equal(pair_items(138, team), pair_items(138, team))


@pytest.mark.parametrize("n", [1, 2, 7, 22, 31, 32, 33, 138, 257, 512])
def test_items_are_dealt_to_each_team_once_for_every_shape(n):
    """For every shape: item m C + rank goes to team m mod (teams a CTA)
    of CTA rank in round m // (teams a CTA); over the rounds that covers
    every item exactly once, and every CTA's items are 0..ceil(...) - 1 of
    its own (the staged tables' rows)."""
    for s in launch_shapes(n):
        tpc = s.threads(n) // s.team
        assert tpc * s.team == s.threads(n)
        seen = np.zeros(s.items(n), np.int64)
        for rank in range(s.cluster):
            m = np.arange(s.rounds(n) * tpc)
            it = m * s.cluster + rank
            mine = it[it < s.items(n)]
            seen[mine] += 1
            assert len(mine) <= -(-s.items(n) // s.cluster)
        assert (seen == 1).all(), (n, s)
        assert s.slots(n) == 2 * (-(-n // s.team))


# --- the chooser ------------------------------------------------------------------------------

H100_SMS = 132


def _register_capacity(n_atoms, regs=128, gpc_sms=14):
    """The card's count of resident replicas as a model with a
    register-limited SM: every build takes ``regs`` registers a thread of
    the SM's 65,536 (at most 32 CTAs); a cluster's CTAs share one GPC,
    counted as one GPC of ``gpc_sms`` SMs for every 16 (an H100 SXM's 132
    SMs sit in 8 GPCs of 14-18)."""
    def capacity(s):
        per_sm = min(32, 65536 // (regs * s.threads(n_atoms)))
        if s.cluster == 1:
            return H100_SMS * per_sm
        return (H100_SMS // 16) * ((gpc_sms * per_sm) // s.cluster)
    return capacity


def test_chooser_under_a_register_limited_sm():
    """The shapes of the paths under register models. At the kernels' 128
    registers a thread, 138-atom chignolin at R=32 takes clusters of 8
    with 8-lane atom teams, 4-lane pair teams and two steps an iteration
    (CTAs of 288 threads, one an SM, leave 8 clusters of 8), and 16-lane
    atom teams at R=8; a build of 112 registers on GPCs of 16 SMs would
    hold 32 clusters of 288-thread CTAs, two an SM, and then R=32 takes
    the 16-lane teams with one item of 8 steps a lane. Every pick holds
    its replicas unless it is the one thread an atom fallback,
    LaunchShape(1, 1)."""
    cap138, cap22 = _register_capacity(138), _register_capacity(22)
    assert launch_shape(138, 32, cap138) == LaunchShape(8, 8, 4, 2)
    assert launch_shape(138, 8, cap138) == LaunchShape(8, 16, 16, 2)
    s = launch_shape(138, 32, _register_capacity(138, regs=112, gpc_sms=16))
    assert s == LaunchShape(8, 16, 16, 2)
    assert s.rounds(138) * s.steps == 8 and s.threads(138) == 288
    assert launch_shape(22, 32, cap22).cluster == 1
    assert LaunchShape(1, 1) == LaunchShape(1, 1, 32, 2)
    for n in (22, 138, 276, 506):
        cap = _register_capacity(n)
        for R in (1, 8, 32, 33, 132, 264, 512):
            s = launch_shape(n, R, cap)
            assert cap(s) >= R or s == LaunchShape(1, 1), (n, R, s)
            assert s in launch_shapes(n)
            assert s.steps % s.pairs == 0 and s.threads(n) <= MAX_THREADS
    # the cost: rounds of items (their steps and start), slot sums, barriers
    assert shape_cost(138, LaunchShape(8, 16, 16, 2)) == pytest.approx(
        1 * (8 * 0.75 + 1.0) + 0.05 * math.ceil(18 / 16) + 0.25 * 4 + 1.5)


# --- the tables and a plain replay of the walk --------------------------------------------

def _alanine(device="cpu"):
    return build_system(alanine_dipeptide_structure(), gb_model="gbn2", device=device)


def _chignolin(device="cpu"):
    return build_system(chignolin_structure(), gb_model="gbn2", device=device)


def _noisy(pos, R, seed, sigma=0.01):
    rng = np.random.default_rng(seed)
    x = pos.cpu().numpy()[None] + rng.normal(0.0, sigma, (R,) + tuple(pos.shape))
    return torch.as_tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("molecule", ["alanine", "chignolin"])
@pytest.mark.parametrize("team", TEAMS)
def test_item_tables_hold_the_dense_tables_entries(molecule, team):
    """Entry (t, s, l) of an item is the dense table's (row, column) entry
    of the pair lane l meets at step s (the neck tables' transposed entries
    for tables 6 and 7), bit for bit, and 0 where the lane takes no pair."""
    system, _ = _alanine() if molecule == "alanine" else _chignolin()
    n = system.n_atoms
    chunk = build_fused_chunk(system, dt=0.002, friction=1.0, n_replicas=1)
    items_t, tab = chunk.item_tables(team)
    _, i, j, ok, _ = _walk(n, team)
    np.testing.assert_array_equal(items_t.numpy(), pair_items(n, team))
    assert tab.shape == (len(items_t), PAIR_TABS, team // 2, team) and tab.dtype == torch.float32
    p = chunk._pair_p.numpy()
    ic, jc = np.where(ok, i, 0), np.where(ok, j, 0)
    want = np.concatenate([p[:, ic, jc], p[4:6, jc, ic]]) * ok
    np.testing.assert_array_equal(tab.numpy(), want.transpose(1, 0, 2, 3))


def _replay_energy_and_forces(chunk, x, team):
    """The kernel's evaluation replayed in float64 on the host from the
    items' tables: each pair once with both atoms' terms summed into each
    atom (in float64 the slots' order does not matter), then the Born
    radii, the chain factors and the forces as the kernel takes them
    (bonded terms from the plain version). Returns (R,) energies and
    (R, N, 3) forces."""
    p = chunk.dense
    n = chunk.system.n_atoms
    _, i, j, ok, _ = _walk(n, team)
    tab = chunk.item_tables(team)[1].double()
    sel = torch.as_tensor(ok)
    ii, jj = torch.as_tensor(i)[sel], torch.as_tensor(j)[sel]
    t = tab.permute(1, 0, 2, 3)[:, sel]                  # (8, pairs)
    x = x.double()
    d = x[:, ii] - x[:, jj]
    r = torch.sqrt((d * d).sum(-1) + 1e-12)
    rho, sr = p.gb_rho.double(), p.gb_sr.double()

    def hct(rr, rho_i, sr_j):
        u = rr + sr_j
        diff = rr - sr_j
        L = torch.where(diff.abs() < rho_i, rho_i, diff.abs())
        dL = torch.where(diff.abs() < rho_i, torch.zeros_like(rr), torch.sign(diff))
        h = 1 / L - 1 / u + 0.25 * (rr - sr_j ** 2 / rr) * (1 / u ** 2 - 1 / L ** 2) \
            + 0.5 * torch.log(L / u) / rr
        dh = (-dL / L ** 2 + 1 / u ** 2
              + 0.25 * (1 + sr_j ** 2 / rr ** 2) * (1 / u ** 2 - 1 / L ** 2)
              + 0.25 * (rr - sr_j ** 2 / rr) * (-2 / u ** 3 + 2 * dL / L ** 3)
              - 0.5 * torch.log(L / u) / rr ** 2 + 0.5 / rr * (dL / L - 1 / u))
        eng = (sr_j - rr) > rho_i
        h = torch.where(eng, h + 2 * (1 / rho_i - 1 / L), h)
        dh = torch.where(eng, dh + 2 * dL / L ** 2, dh)
        act = ~(u <= rho_i)
        return torch.where(act, h, 0 * h), torch.where(act, dh, 0 * dh)

    def neck(rr, d0, m0):
        u = rr - d0
        den = 1 + 100 * u ** 2 + 0.3e6 * u ** 6
        return m0 / den, -m0 * (200 * u + 1.8e6 * u ** 5) / den ** 2

    def slot_sum(row_terms, col_terms):
        # every pair's row term to its row atom, its column term to its column atom
        R = row_terms.shape[0]
        out = torch.zeros((R, n) + row_terms.shape[2:], dtype=torch.float64)
        out.index_add_(1, ii, row_terms)
        out.index_add_(1, jj, col_terms)
        return out

    H_ij, dH_ij = hct(r, rho[ii], sr[jj])
    H_ji, dH_ji = hct(r, rho[jj], sr[ii])
    n_ij, dn_ij = neck(r, t[4], t[5])
    n_ji, dn_ji = neck(r, t[6], t[7])
    I = slot_sum(0.5 * H_ij + n_ij, 0.5 * H_ji + n_ji)
    psi = I * rho
    al, be, ga = p.gb_alpha.double(), p.gb_beta.double(), p.gb_gamma.double()
    radii = p.gb_radii.double()
    th = torch.tanh(al * psi - be * psi ** 2 + ga * psi ** 3)
    inv_b_raw = 1 / rho - th / radii
    B = 1 / torch.clamp(inv_b_raw, min=1e-3)
    dB = torch.where(inv_b_raw < 1e-3, 0 * B,
                     B ** 2 * (1 - th ** 2) * (al - 2 * be * psi + 3 * ga * psi ** 2) / radii)
    Bi, Bj = B[:, ii], B[:, jj]
    r2 = r * r
    expu = torch.exp(-r2 / (4 * Bi * Bj))
    inv_f = 1 / torch.sqrt(r2 + Bi * Bj * expu)
    qq = t[3]
    dEdf = -qq * inv_f ** 2
    acc = slot_sum(dEdf * expu * (Bj + r2 / (4 * Bi)) * 0.5 * inv_f,
                   dEdf * expu * (Bi + r2 / (4 * Bj)) * 0.5 * inv_f)
    q, sa = p.q.double(), p.sa_coef.double()
    gb_pref = float(p.gb_pref)
    dEdB = 2 * acc - gb_pref * q ** 2 / B ** 2 - 6 * sa / B ** 7
    chain = dEdB * dB * rho
    la, lb, qs = t[0], t[1], t[2]
    g = -12 * la / r ** 13 + 6 * lb / r ** 7 - qs / r ** 2
    g = g + 2 * dEdf * r * (1 - 0.25 * expu) * inv_f
    g = g + chain[:, ii] * (0.5 * dH_ij + dn_ij) + chain[:, jj] * (0.5 * dH_ji + dn_ji)
    coef = (g / r)[..., None]
    F = slot_sum(-coef * d, coef * d)
    e = ((la / r ** 12 - lb / r ** 6 + qs / r) + 2 * qq * inv_f).sum(1)
    e = e + (gb_pref * q ** 2 / B + sa / B ** 6).sum(1)
    bonded = analytic.make_dense_params(chunk.system, dtype=torch.float64)
    zero = dict(lj_a=0 * bonded.lj_a, lj_b=0 * bonded.lj_b, qq_scaled=0 * bonded.qq_scaled)
    eb, fb = analytic.energy_and_forces(dataclasses.replace(bonded, use_gb=False, **zero), x)
    return e + eb, F + fb


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("molecule", ["alanine", "chignolin"])
def test_walk_replay_matches_the_analytic_forces_and_jax(molecule, team):
    """The walk's arithmetic (each pair once, both Born directions and neck
    terms, the GB energy of both orders, the force on both atoms, slots in
    order) against the plain version the kernel is held to on the card
    (``analytic.energy_and_forces`` over the dense tables) and against
    JAX's analytic energy and forces, at fixed positions made by numpy from
    a seed: E within 1e-5 relative, F within 1e-4 of max |F|."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu.md.integrate import make_force_fn

    system, pos = _alanine() if molecule == "alanine" else _chignolin()
    chunk = build_fused_chunk(system, dt=0.002, friction=1.0, n_replicas=2)
    x = _noisy(pos, 2, seed=13)
    e, f = _replay_energy_and_forces(chunk, x, team)
    ep, fp = analytic.energy_and_forces(chunk.dense, x)
    assert float((e - ep.double()).abs().max() / ep.abs().max()) <= 1e-5
    assert float((f - fp.double()).abs().max() / fp.abs().max()) <= 1e-4
    if molecule == "alanine":
        js, _ = jax_build_system(jax_alanine(), gb_model="gbn2")
        force_fn = make_force_fn(js, analytic=True)
        je, jf = jax.vmap(force_fn)(jnp.asarray(x.numpy()))
        je, jf = np.asarray(je, np.float64), np.asarray(jf, np.float64)
        assert np.abs(e.numpy() - je).max() / np.abs(je).max() <= 1e-5
        assert np.abs(f.numpy() - jf).max() / np.abs(jf).max() <= 1e-4


def test_frame_energy_is_the_evaluation_the_next_step_uses():
    """``run_fused`` on the CPU (its plain version): a frame's energy is
    the energy of the evaluation at the frame's positions, bit for bit,
    and one step continued from the frame's state with the force of that
    evaluation is the plain chunk's next step: one force evaluation a step
    serves both, as in the kernel."""
    system, pos = _alanine()
    cfg = RemdConfig(n_replicas=4, t_min=300.0, t_max=450.0, exchange_frequency=6,
                     report_interval=3, seed=3)
    remd = ReplicaExchange(system, pos, cfg, device="cpu", minimize=False)
    out = remd._run_fused_reference(2, 2)
    for k in range(out.frames.shape[0]):
        e, _ = remd._chunk.energy_and_forces(out.frames[k])
        assert torch.equal(out.frame_energy[k], e)
    chunk = remd._chunk
    x, v = out.frames[0], torch.zeros_like(out.frames[0])
    seeds = torch.arange(4, dtype=torch.int32)
    temps = remd.ladder
    x1, v1, _ = chunk.reference(x, v, seeds, temps, 1, 0)
    from pmarlo_tpu_torch.md.integrate import gaussian_noise
    _, f = chunk.energy_and_forces(x)
    m = system.masses[None, :, None]
    c1 = math.exp(-chunk.friction * chunk.dt)
    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * temps[:, None, None]
    vk = v + chunk.dt * f / m
    xk = x + 0.5 * chunk.dt * vk
    vk = c1 * vk + torch.sqrt((1 - c1 * c1) * kT / m) * gaussian_noise(seeds, 0, system.n_atoms)
    xk = xk + 0.5 * chunk.dt * vk
    torch.testing.assert_close(x1, xk, rtol=0, atol=1e-6)
    torch.testing.assert_close(v1, vk, rtol=0, atol=1e-5)


# --- the kernels on the card ----------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _quads(structure):
    info = TopologyInfo.from_topology(build_topology(structure))
    phi, psi, _ = phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    return np.concatenate([phi, psi], axis=0)


def _tiny_model(n_dih, device, seed=0):
    rng = np.random.default_rng(seed)
    cfg = DeepTICAConfig(hidden=(32, 32))
    k = 2 * n_dih
    sizes = [k, *cfg.hidden, cfg.n_out]
    params = [{"w": rng.normal(0.0, np.sqrt(2.0 / (a + b)), (a, b)).astype(np.float32),
               "b": rng.normal(0.0, 0.1, b).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    whitening = {"mean": rng.normal(0.0, 0.1, cfg.n_out).astype(np.float32),
                 "transform": rng.normal(0.0, 1.0, (cfg.n_out, cfg.n_out)).astype(np.float32)}
    return deeptica_from_numpy(cfg, params, rng.normal(0.0, 0.3, k).astype(np.float32),
                               rng.uniform(0.5, 1.0, k).astype(np.float32), whitening,
                               device=device)


def _card_remd(molecule, R, biased):
    structure = alanine_dipeptide_structure() if molecule == "alanine" else chignolin_structure()
    system, pos = build_system(structure, gb_model="gbn2", device="cuda")
    quads = _quads(structure)
    kb = ({"model": _tiny_model(len(quads), "cuda"), "quads": quads, "strength": 2.0}
          if biased else None)
    cfg = RemdConfig(n_replicas=R, t_min=300.0, t_max=450.0, exchange_frequency=20,
                     report_interval=10, seed=4)

    def make():
        return ReplicaExchange(system, pos, cfg, device="cuda", use_kernel=True,
                               kernel_bias=kb, minimize=False)
    return system, make


def _widths(chunk, R):
    """For each pair-team width and steps an iteration, the cheapest shape
    (``shape_cost``) whose replicas the card holds at once in both the
    chunk and the whole-run kernel."""
    n = chunk.system.n_atoms
    ints = chunk._common_args(R, 0)[1]
    out = []
    for T in TEAMS:
        for P in (1, 2):
            fits = [s for s in launch_shapes(n) if s.team == T and s.pairs == P and min(
                chunk._plan_of(m, ints, s)["resident"] for m in (0, 2)) >= R]
            if fits:
                out.append(min(fits, key=lambda s: shape_cost(n, s)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("biased", [False, True], ids=["unbiased", "kernel_bias"])
@pytest.mark.parametrize("molecule", ["alanine", "chignolin"])
@pytest.mark.parametrize("R", [2, 8, 32, 33])
def test_remd_kernels_match_plain_and_windowed_at_every_width(molecule, R, biased):
    """Both row 2 kernels (``fused_remd_kernel`` / ``fused_remd_bias_kernel``
    and their wide builds) at the chooser's shape and at every pair-team
    width and steps an iteration: against ``_run_fused_reference`` from the
    same state (frames to 1e-3 nm, energies to 1e-4, ``ids_hist`` equal)
    and against the windowed kernel path (frames bit for bit, ``ids_hist``
    and acceptance equal); two launches bitwise equal."""
    _need_card()
    system, make = _card_remd(molecule, R, biased)
    for shape in [None, *_widths(make()._chunk, R)]:
        a, b, c = make(), make(), make()
        if shape is not None:
            for r in (a, b, c):
                r._chunk._shapes[R] = shape
        ref = a._run_fused_reference(2, 2)
        before = fused_md.variant_launches["fused_remd"]
        rf = a.run_fused(40)
        rf2 = c.run_fused(40)
        rw = b.run(40)
        torch.cuda.synchronize()
        assert fused_md.variant_launches["fused_remd"] == before + 2
        e_ref = ref.frame_energy.cpu().numpy()
        np.testing.assert_array_equal(rf.replica_ids, ref.ids_hist.cpu().numpy())
        assert np.abs(rf.positions - ref.frames.cpu().numpy()).max() <= 1e-3, shape
        assert np.abs(rf.potential_energy - e_ref).max() <= 1e-4 * np.abs(e_ref).max(), shape
        np.testing.assert_array_equal(rf.positions, rw.positions)
        np.testing.assert_array_equal(rf.replica_ids, rw.replica_ids)
        np.testing.assert_allclose(rf.acceptance_matrix, rw.acceptance_matrix, equal_nan=True)
        np.testing.assert_array_equal(rf.positions, rf2.positions)
        np.testing.assert_array_equal(rf.potential_energy, rf2.potential_energy)
        if shape is not None:
            assert a._chunk.last_launch["team"] == shape.team
            assert a._chunk.last_launch["pairs"] == shape.pairs
