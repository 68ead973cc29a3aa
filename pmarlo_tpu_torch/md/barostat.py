"""Monte-Carlo barostat: constant-pressure (NPT) sampling.

Port of ``pmarlo_tpu/md/barostat.py`` (OpenMM ``MonteCarloBarostat``
semantics, Frenkel & Smit ch. 5.4):

* every ``interval`` MD steps, propose ``V' = V + dV`` with
  ``dV ~ U(-w, w)``;
* scale molecule centres by ``s = (V'/V)^(1/3)``: molecules translate
  rigidly, so bond lengths, angles and constrained geometries stay exactly
  satisfied and no velocity changes;
* accept with ``min(1, exp(-[dU + P dV - N_mol kT ln(V'/V)] / kT))``;
* the proposal width tunes itself toward ~50% acceptance (every 10
  attempts: shrink 10% under 0.25, grow 10% over 0.75, clamped to 30% of
  the volume).

The box is a (3,) float32 tensor on the run's device, and the cell sweep's
``dynamic`` entries (``md/cell_force.py``) derive the shifts, the wrap, the
minimum image, the dispersion tail and the PME influence function from it.
A move is device operations only: the uniforms, the energies, the decision
(``torch.where``), the width tuning; no value is read back to the host, so
a move never waits for the card. A move into a box whose cell layers are
thinner than the cutoff sees a NaN energy and is rejected.

**The move stream.** JAX splits a key a move. Here the two uniforms of move
``k`` are Philox4x32-10 with key ``(seed, BAROSTAT_KEY)`` and counter ``(k
low word, k high word, 0, 0)``; the Langevin noise keys Philox with
``(seed, replica index)`` (``md/integrate.py gaussian_noise``) and the swap
stream with ``(seed, SWAP_KEY)``, so the three never share a block. The
move also takes its uniforms injected (``uniforms=``), which lets a test
hold its decisions against JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._device import default_device
from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from .integrate import (
    MDState,
    _inv_mass,
    _uniform24,
    bias_energy_and_forces,
    instantaneous_temperature,
    langevin_step,
    philox4x32_10,
)
from .system import System

#: 1 bar in kJ/mol/nm^3 (1e5 J/m^3 * 1e-27 m^3/nm^3 * N_A / 1000)
BAR_TO_KJ_PER_MOL_NM3 = 0.06022140760
#: 1 amu/nm^3 in g/cm^3
AMU_PER_NM3_TO_G_PER_CM3 = 1.66053906660e-3
#: second Philox key word of the move stream ("BARO")
BAROSTAT_KEY = 0x4241524F


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def molecule_ids(system: System) -> np.ndarray:
    """Per-atom molecule id (0..n_mols-1) from bond connectivity
    (host-side union-find over ``bond_idx``; rigid waters keep their
    O-H bonds in the UNSTRIPPED system, so pass that one)."""
    n = system.n_atoms
    parent = np.arange(n)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    bonds = _np(system.bond_idx).reshape(-1, 2)
    for a, b in bonds:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[rb] = ra
    roots = np.array([find(i) for i in range(n)])
    _, ids = np.unique(roots, return_inverse=True)
    return ids.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BarostatState:
    """The barostat's carry between moves and between segments."""

    box: torch.Tensor            # (3,) float32 nm
    seed: int                    # Philox key of the move stream
    dv: torch.Tensor             # () float32 proposal half-width (nm^3)
    n_attempted: int             # moves made: the counter of the move stream
    n_accepted: torch.Tensor     # () int32
    win_attempted: int           # attempts in the current tuning window
    win_accepted: torch.Tensor   # () int32 accepts in the current tuning window


def init_barostat(box, seed: int = 0, dv_initial: Optional[float] = None,
                  device=None) -> BarostatState:
    """A fresh barostat at ``box`` on ``device`` (``None``: the box
    tensor's, else ``_device.default_device()``); the width starts at 1%
    of the volume, as in JAX."""
    if device is None:
        device = box.device if isinstance(box, torch.Tensor) else default_device()
    host = _np(box).astype(np.float32)
    b = torch.as_tensor(host, device=device)
    v0 = float(np.prod(host))
    dv = float(dv_initial) if dv_initial is not None else 0.01 * v0
    z = torch.zeros((), dtype=torch.int32, device=device)
    return BarostatState(box=b, seed=int(seed), dv=torch.tensor(dv, dtype=torch.float32,
                                                                device=device),
                         n_attempted=0, n_accepted=z, win_attempted=0, win_accepted=z)


def barostat_state_from_numpy(box, seed: int, dv, n_attempted, n_accepted,
                              win_attempted, win_accepted, device=None) -> BarostatState:
    """A barostat state from host values (a JAX ``BarostatState``'s box,
    width and counters); the move stream is keyed by ``seed``."""
    state = init_barostat(box, seed, float(np.asarray(dv)), device=device)
    dev = state.box.device

    def count(v):
        return torch.tensor(int(np.asarray(v)), dtype=torch.int32, device=dev)

    return dataclasses.replace(state, n_attempted=int(np.asarray(n_attempted)),
                               n_accepted=count(n_accepted),
                               win_attempted=int(np.asarray(win_attempted)),
                               win_accepted=count(win_accepted))


def barostat_uniforms(seed: int, move: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u_dv in (-1, 1), u_acc in (0, 1))`` of move ``move``: Philox with
    key ``(seed, BAROSTAT_KEY)`` and counter ``(move, 0, 0)``."""
    def word(v):   # a fill, not a copy from the host
        return torch.full((), int(v), dtype=torch.int64, device=device)

    w0, w1, _, _ = philox4x32_10(word(move & 0xFFFFFFFF), word((move >> 32) & 0xFFFFFFFF),
                                 word(0), word(0), word(int(seed) & 0xFFFFFFFF),
                                 word(BAROSTAT_KEY))
    return 2.0 * _uniform24(w0) - 1.0, _uniform24(w1)


class _Molecules:
    """Molecule sums in a fixed order: the atoms sorted by molecule, a
    float64 running sum and its differences at the molecules' ends (no
    atomics, the same bits on every run)."""

    def __init__(self, mol_id, masses, n_mols: int, device):
        mol = _np(mol_id).astype(np.int64)
        order = np.argsort(mol, kind="stable")
        ends = np.cumsum(np.bincount(mol, minlength=int(n_mols)))
        starts = np.concatenate([[0], ends[:-1]])
        self.mol = torch.as_tensor(mol, device=device)
        self.order = torch.as_tensor(order, device=device)
        self.starts = torch.as_tensor(starts, device=device)
        self.ends = torch.as_tensor(ends, device=device)
        self.m = torch.as_tensor(_np(masses).astype(np.float64)[order], device=device)

    def com(self, x: torch.Tensor) -> torch.Tensor:
        """Mass-weighted centres ``(..., n_mols, 3)`` float64."""
        xs = x[..., self.order, :].double()
        w = torch.cat([self.m[:, None] * xs, self.m[:, None].expand(xs.shape[:-1] + (1,))],
                      dim=-1)
        c = torch.cumsum(w, dim=-2)
        c = torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)
        seg = c[..., self.ends, :] - c[..., self.starts, :]
        return seg[..., :3] / seg[..., 3:]

    def scale(self, x: torch.Tensor, s) -> torch.Tensor:
        return x + (s - 1.0) * self.com(x)[..., self.mol, :].to(x.dtype)


def scale_positions(x: torch.Tensor, s, mol_id, masses, n_mols: int) -> torch.Tensor:
    """Isotropic volume-move position update: translate every molecule
    rigidly so its mass-weighted centre scales by ``s``; intramolecular
    geometry (bond lengths, rigid waters) is exactly preserved."""
    return _Molecules(mol_id, masses, n_mols, x.device).scale(x, s)


def make_volume_move(
    energy_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mol_id,
    masses,
    n_mols: int,
    *,
    pressure_bar: float,
    temperature_K: float,
    device=None,
):
    """The Monte-Carlo volume move.

    ``energy_fn(x, box) -> potential energy`` at the given box tensor (the
    cell force's ``dynamic`` returns (e, f); wrap it). Returns ``move(x,
    bstate, uniforms=None) -> (x', bstate', accepted, energy)``, all on the
    device, with ``energy`` the potential AFTER the decision, so that a
    reported frame pairs positions, box and energy of one configuration.
    ``uniforms`` injects ``(u_dv in [-1, 1), u_acc in [0, 1))`` in place of
    the move stream's."""
    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * float(temperature_K)
    P = BAR_TO_KJ_PER_MOL_NM3 * float(pressure_bar)
    molecules = {}

    def move(x: torch.Tensor, bstate: BarostatState, uniforms=None):
        dev = x.device
        if dev not in molecules:
            molecules[dev] = _Molecules(mol_id, masses, n_mols, dev)
        if uniforms is None:
            u_dv, u_acc = barostat_uniforms(bstate.seed, bstate.n_attempted, dev)
        else:   # a number is filled in on the device, not copied from the host
            u_dv, u_acc = (u.to(dtype=torch.float32, device=dev) if isinstance(u, torch.Tensor)
                           else torch.full((), float(u), dtype=torch.float32, device=dev)
                           for u in uniforms)
        box = bstate.box
        v0 = box[0] * box[1] * box[2]
        dv = u_dv * bstate.dv
        v1 = torch.maximum(v0 + dv, 0.1 * v0)
        s = (v1 / v0) ** (1.0 / 3.0)
        box1 = box * s
        x1 = molecules[dev].scale(x, s)

        e0 = energy_fn(x, box)
        e1 = energy_fn(x1, box1)
        # a NaN energy (the cutoff cover broken) rejects: u < NaN is False
        w = (e1 - e0) + P * (v1 - v0) - n_mols * kT * torch.log(v1 / v0)
        accepted = u_acc < torch.exp(torch.clamp(-w / kT, max=0.0))

        x_new = torch.where(accepted, x1, x)
        box_new = torch.where(accepted, box1, box)

        # OpenMM-style width adaptation every 10 attempts
        wa = bstate.win_attempted + 1
        wacc = bstate.win_accepted + accepted.to(torch.int32)
        dv_new = bstate.dv
        if wa >= 10:
            frac = wacc.to(torch.float32) / float(max(wa, 1))
            dv_t = torch.where(frac < 0.25, bstate.dv / 1.1,
                               torch.where(frac > 0.75, bstate.dv * 1.1, bstate.dv))
            v_now = box_new[0] * box_new[1] * box_new[2]
            dv_new = torch.minimum(torch.clamp(dv_t, min=1e-6), 0.3 * v_now)
            wa, wacc = 0, torch.zeros_like(wacc)
        new_state = BarostatState(
            box=box_new, seed=bstate.seed, dv=dv_new,
            n_attempted=bstate.n_attempted + 1,
            n_accepted=bstate.n_accepted + accepted.to(torch.int32),
            win_attempted=wa, win_accepted=wacc,
        )
        e_now = torch.where(accepted, e1, e0)
        return x_new, new_state, accepted, e_now

    return move


def run_npt(
    system: System,
    state: MDState,
    *,
    n_steps: int,
    dt: float,
    friction: float,
    temperature_K: float,
    pressure_bar: float = 1.0,
    barostat_interval: int = 25,
    report_interval: int = 100,
    force_fn,
    constraints=None,
    full_system: Optional[System] = None,
    seed: int = 0,
    barostat_state: Optional[BarostatState] = None,
    bias_fn: Optional[Callable] = None,
) -> Tuple[MDState, BarostatState, dict]:
    """NPT MD: Langevin (NVT) stretches of ``barostat_interval`` steps, each
    followed by a volume move.

    ``force_fn`` must be a cell force (``build_cell_force_fn``): its
    ``dynamic`` / ``init_state_dynamic`` / ``apply_dynamic`` entries take
    the box tensor. ``full_system`` (default ``system``) supplies the bond
    connectivity for the molecule grouping: pass the unstripped system
    when MD forces run on ``strip_constrained_bonded`` output.
    ``bias_fn(x) -> energy`` reaches both legs: the Langevin force and the
    move's energy difference (``setup.compose_bias``'s rule).
    ``barostat_state``, a previous call's, continues a run: the evolved
    box, the tuned width and the move stream; without it the barostat
    starts at ``system.box`` with the move stream keyed by ``seed``.

    The loop is Python over ``langevin_step(..., force_state=)``; nothing
    is read back to the host, frames included. Returns (final MDState,
    final BarostatState, report) with tensors positions (F, N, 3), box (F,
    3), density_g_cm3 (F,), potential_energy (F,) (after each report's last
    move) and temperature (F,) (of the velocities synchronised by the
    trailing half kick, RATTLE'd, as ``run_md`` reports)."""
    for name in ("dynamic", "init_state_dynamic", "apply_dynamic"):
        if not hasattr(force_fn, name):
            raise ValueError(
                "run_npt needs a cell-list force fn with dynamic-box "
                f"support (missing .{name}); build it via "
                "build_cell_force_fn"
            )
    if system.box is None:
        raise ValueError("run_npt needs a periodic system (system.box)")
    if n_steps % report_interval != 0:
        raise ValueError("n_steps must be a multiple of report_interval")
    if report_interval % barostat_interval != 0:
        raise ValueError(
            "report_interval must be a multiple of barostat_interval"
        )
    conn = full_system if full_system is not None else system
    mol = molecule_ids(conn)
    n_mols = int(mol.max()) + 1
    total_mass = float(_np(system.masses).astype(np.float64).sum())
    dev = state.positions.device

    if bias_fn is not None:
        def _move_energy(x, b):
            return force_fn.dynamic(x, b)[0] + bias_fn(x)

        def _apply_dynamic(x, fs, box):
            e, f, fs2 = force_fn.apply_dynamic(x, fs, box)
            be, bf = bias_energy_and_forces(bias_fn, x)
            return e + be, f + bf, fs2
    else:
        def _move_energy(x, b):
            return force_fn.dynamic(x, b)[0]

        _apply_dynamic = force_fn.apply_dynamic

    move = make_volume_move(_move_energy, mol, system.masses, n_mols,
                            pressure_bar=pressure_bar, temperature_K=temperature_K)
    n_con = 0
    if constraints is not None:
        from .constraints import n_constraints, rattle

        n_con = n_constraints(constraints)
    if barostat_state is None:
        barostat_state = init_barostat(system.box, seed, device=dev)
    bstate = barostat_state
    inv_m = _inv_mass(system)
    fstate = force_fn.init_state_dynamic(state.positions, bstate.box)
    frames = {k: [] for k in ("positions", "box", "density_g_cm3", "potential_energy",
                              "temperature")}
    for _ in range(n_steps // report_interval):
        for _ in range(report_interval // barostat_interval):
            box = bstate.box
            for _ in range(barostat_interval):
                state, _, fstate = langevin_step(
                    system, state, dt=dt, friction=friction, temperature_K=temperature_K,
                    force_fn=lambda x, fs, box=box: _apply_dynamic(x, fs, box),
                    constraints=constraints, force_state=fstate,
                )
            # the next call bins afresh under the (possibly) new box, so
            # the neighbour state needs no rebinning here
            x_new, bstate, _, e_now = move(state.positions, bstate)
            state = dataclasses.replace(state, positions=x_new)
        _, f_now, fstate = _apply_dynamic(state.positions, fstate, bstate.box)
        v_sync = state.velocities + 0.5 * dt * f_now * inv_m
        if constraints is not None:
            v_sync = rattle(constraints, v_sync, state.positions)
        box = bstate.box
        frames["positions"].append(state.positions)
        frames["box"].append(box)
        frames["density_g_cm3"].append(
            AMU_PER_NM3_TO_G_PER_CM3 * total_mass / (box[0] * box[1] * box[2]))
        frames["potential_energy"].append(e_now)
        frames["temperature"].append(instantaneous_temperature(system, v_sync, n_con))
    return state, bstate, {k: torch.stack(v) for k, v in frames.items()}


__all__ = [
    "AMU_PER_NM3_TO_G_PER_CM3", "BAR_TO_KJ_PER_MOL_NM3", "BAROSTAT_KEY", "BarostatState",
    "barostat_state_from_numpy", "barostat_uniforms", "init_barostat", "make_volume_move",
    "molecule_ids", "run_npt", "scale_positions",
]
