"""Fused multi-step Langevin chunk: a CUDA kernel and its plain twin.

Port of ``pmarlo_tpu/md/pallas_md.py``: ``build_pallas_chunk`` (unbiased,
with the in-kernel DeepTICA bias, with the hills ledger as input, and with
the deposits fused into the launch) and ``build_pallas_remd`` (the whole
REMD run in one launch). ``build_fused_chunk`` returns a ``FusedChunk``;
calling it advances every replica ``n_steps`` folded-BAOAB steps and
returns the energies at the final positions:

    chunk(x, v, seeds, temps, n_steps, step_offset) -> (x, v, energies)
    chunk(..., hills=ledger) -> the same under the metadynamics bias, or,
        built with ``mtd_deposit_interval``, (x, v, energies, ledger)
    chunk.remd(x, v, seeds, ids, ladder, ...) -> ``FusedRemdOutput``

- tensors on a CUDA device launch ``csrc/fused_md.cu`` (one launch per
  call; ``launches`` counts the unbiased chunk and ``variant_launches``
  the other kernels by name). A CUDA tensor never reaches the plain
  version: the launch happens or the call raises. Each replica is a
  cluster of ``C`` CTAs, each atom a team of ``L`` lanes for its own
  sums, and the pairs ``pair_items``' items of a team of ``T`` lanes
  each, every unordered pair once; ``launch_shape`` chooses C, L, T and
  the steps a lane takes an iteration from the atom and replica counts
  and the card. ``chunk.remd(..., stamps=True)`` launches the stamped
  build of the whole-run kernel, which also returns the clock64 stamps of
  one sampled step a report block (``FusedRemdOutput.stamps``;
  ``step_phase_cycles`` sums them by ``STAMP_PHASES``) and computes the
  same bits.
- tensors on the CPU run ``FusedChunk.reference``: ``langevin_step`` over
  ``analytic.energy_and_forces`` plus the bias twin (``md/cv_bias.py``),
  with the same Philox noise stream; deposits are
  ``MetadynamicsBias.deposit`` in replica order. The whole-run REMD twin
  is ``ReplicaExchange._run_fused_reference`` (``remd/remd.py``), which
  ``run_fused`` takes on the CPU.

``n_steps`` is a runtime argument (no per-size prebuild), and
``step_offset`` is the global index of the first step, which keys the
noise: successive windows must pass successive offsets.

The kernel library is compiled with ``nvcc`` from ``pmarlo_tpu_torch/csrc``
at first use (``_kernels.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..bias.metadynamics import MetadynamicsBias, MetaDState
from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from ..utils import profiling
from .analytic import energy_and_forces, make_dense_params
from .bonded_window import bonded_csr, bonded_slots
from .cv_bias import MAX_CV, MAX_LAYERS, CVBias
from .integrate import MDState, langevin_step
from .system import System, require_no_vsites

#: launches of the unbiased chunk kernel made by this process
#: (chip_smoke.py resets and reads it)
launches = 0

#: launches of the other kernels of ``csrc/fused_md.cu``, by name
variant_launches = {
    "bias_harmonic": 0,        # chunk with the harmonic CV bias
    "bias_metadynamics": 0,    # chunk with the hills ledger as input
    "fused_metadynamics": 0,   # chunk with the deposits inside the launch
    "fused_remd": 0,           # the whole REMD run
}

#: atoms per replica the kernels take: with one lane an atom and one CTA a
#: replica (the shape every replica count falls back to) a CTA has one
#: thread an atom, at most 512
MAX_ATOMS = 512
#: threads a CTA and CTAs a replica (a thread-block cluster) at most
MAX_THREADS = 512
MAX_CLUSTER = 8
_CLUSTERS = (1, 2, 4, 8)
_LANES = (1, 2, 4, 8, 16, 32)
_TEAMS = (2, 4, 8, 16, 32)
#: cost model of the chooser, in pair steps a lane takes a step: a step of
#: two overlapped pairs (P = 2) against one, an item's start (its load, the
#: row atom, the slot writes: about one force step on an H100, clock64
#: stamps of chignolin at R = 8 and 32), a slot an atom team's lane adds,
#: one level of the atom team's shuffle sums, and the cluster barriers of a
#: step (chip_smoke.py's shape sweeps on an H100: a cluster of 2-8 CTAs cost 3.4-5.5
#: us a step more)
_STEP_COST = {1: 1.0, 2: 0.75}
_ROUND_COST = 1.0
_FOLD_COST = 0.05
_SHUFFLE_COST = 0.25
_CLUSTER_COST = 1.5
#: tables of a pair in item order (``item_tables``; ``PairTab`` in the
#: kernel): LJ A, LJ B, the scaled and the full charge products, the neck
#: d0 and m0 of (row, column) and of (column, row)
PAIR_TABS = 8

# argument order of pmarlo_fused_md_launch (the enums of csrc/fused_md.cu)
_PTRS = (
    "x", "v", "energy", "forces", "seeds", "kT", "atom_p", "items", "item_tab",
    "slot_scratch", "bond_i",
    "bond_p", "angle_i", "angle_p", "tors_i", "tors_p", "csr_ptr", "bonded_slot",
    "quads", "dih_ptr", "dih_ent", "bias_p", "mtd_centers", "mtd_heights",
    "mtd_count", "cv_buf", "x_out", "v_out", "seeds_out", "ladder",
    "betas", "ids0", "frames", "frame_e", "frame_ke", "ids_hist", "accept",
    "swap_e", "stamps",
)
_INTS = (
    "n_replicas", "n_atoms", "n_steps", "use_gb", "use_neck", "bias_kind",
    "n_dih", "n_layers", *(f"width{l}" for l in range(MAX_LAYERS + 1)),
    "n_cv", "use_whiten", "bias_p_len", "mtd_capacity", "mtd_interval",
    "n_attempts", "frames_per_attempt", "report_interval", "swap_seed",
    "cluster", "lanes", "team", "pairs", "staged", "slots_smem", "n_bonds", "n_angles",
    "n_torsions", "bonded_ld",
)
_FLOATS = (
    "dt", "half_dt", "c1", "c2sq", "gb_pref", "bias_strength", "mtd_height",
    "mtd_kb_dt", *(f"mtd_inv_sigma{k}" for k in range(MAX_CV)),
)
_MODE_CHUNK, _MODE_FUSED_MTD, _MODE_FUSED_REMD = 0, 1, 2
# what pmarlo_fused_md_plan writes: threads, the shared memory bytes of the
# base, the slots and the staged tables, the replicas resident with the
# base alone, with the slots, with slots and tables (0: does not fit)
_PLAN = ("threads", "smem_bytes", "slot_bytes", "table_bytes", "resident",
         "resident_slots", "resident_all")
_BIAS_KINDS = {"harmonic": 1, "metadynamics": 2}
#: the phases of a sampled step (csrc/fused_md.cu, file header): the three
#: pair sweeps and the bonded terms; the owners' slot sums and bonded
#: incidences; waiting at the replica barriers and the last block barrier;
#: the CV bias's dihedrals, MLP and atom forces; the rest
STAMP_PHASES = ("pairs", "folds", "barriers", "bias", "other")
#: the phase of the interval from each StampAt boundary of csrc/fused_md_body.cuh
#: to the next (19 intervals between 20 boundaries)
STAMP_INTERVALS = (
    "other", "barriers", "bias",                    # integration, barrier, CV bias
    "pairs", "barriers", "folds", "other", "barriers",  # Born radius
    "pairs", "barriers", "folds", "other", "barriers",  # dE/dB, chain factor
    "pairs", "barriers", "folds", "bias", "other", "barriers",  # forces
)
STAMP_BOUNDARIES = len(STAMP_INTERVALS) + 1
#: cudaErrorCooperativeLaunchTooLarge
_TOO_LARGE = 720

_configured = False


def _library() -> ctypes.CDLL:
    global _configured
    lib = _kernels.library()
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pmarlo_fused_md_launch.argtypes = [
            i, p, p, p, ctypes.c_longlong, ctypes.c_longlong, p]
        lib.pmarlo_fused_md_launch.restype = i
        lib.pmarlo_fused_md_max_atoms.argtypes = []
        lib.pmarlo_fused_md_max_atoms.restype = i
        lib.pmarlo_fused_md_abi.argtypes = [i]
        lib.pmarlo_fused_md_abi.restype = i
        lib.pmarlo_fused_md_plan.argtypes = [i, p, p]
        lib.pmarlo_fused_md_plan.restype = i
        lib.pmarlo_grid_barrier_probe.argtypes = [i, i, i, i, p]
        lib.pmarlo_grid_barrier_probe.restype = i
        if lib.pmarlo_fused_md_max_atoms() != MAX_ATOMS:
            raise RuntimeError("kernel library and wrapper disagree on MAX_ATOMS")
        abi = [lib.pmarlo_fused_md_abi(k) for k in range(10)]
        if abi != [len(_PTRS), len(_INTS), len(_FLOATS), MAX_LAYERS, MAX_CV,
                   MAX_THREADS, MAX_CLUSTER, len(_PLAN), PAIR_TABS, STAMP_BOUNDARIES]:
            raise RuntimeError(
                f"kernel library and wrapper disagree on the argument lists: {abi}")
        _configured = True
    return lib


@dataclasses.dataclass(frozen=True)
class LaunchShape:
    """How the kernels lay out one replica of ``n`` atoms: a cluster of
    ``cluster`` CTAs, CTA k owning atoms ``[k rows(n), (k + 1) rows(n))``,
    each owned atom a team of ``lanes`` lanes of one warp (its slot sums,
    bonded terms, integration), ``threads(n)`` threads a CTA; the pairs in
    ``pair_items(n, team)``' items, an item a team of ``team`` lanes, and
    ``pairs`` steps a lane an iteration (2: the ``*_kernel`` builds; 1:
    the ``*_single_kernel`` builds; the biased kernels have one build, one
    step an iteration, for both; every build at most 128 registers a
    thread). ``shape_of`` in ``csrc/fused_md.cu`` derives the same."""

    cluster: int
    lanes: int
    team: int = 32
    pairs: int = 2

    def rows(self, n_atoms: int) -> int:
        return -(-int(n_atoms) // self.cluster)

    def threads(self, n_atoms: int) -> int:
        return -(-self.rows(n_atoms) * self.lanes // 32) * 32

    @property
    def steps(self) -> int:
        """Steps an item: half a team."""
        return self.team // 2

    def items(self, n_atoms: int) -> int:
        return pair_groups(n_atoms, self.team) ** 2

    def slots(self, n_atoms: int) -> int:
        """Slots an atom: one for each item that holds it."""
        return 2 * pair_groups(n_atoms, self.team)

    def rounds(self, n_atoms: int) -> int:
        """Items a team takes in turn: the cluster's teams take them in rounds."""
        teams = self.cluster * (self.threads(n_atoms) // self.team)
        return -(-self.items(n_atoms) // teams)


def pair_groups(n_atoms: int, team: int) -> int:
    return -(-int(n_atoms) // int(team))


def pair_items(n_atoms: int, team: int) -> np.ndarray:
    """The item list of the kernels' pair sweeps, ``(G^2, 4)`` int32 for G
    groups of ``team`` atoms: (first row atom, first column atom, first step
    | diagonal << 16, row slot | column slot << 16). Patches (g, h >= g) in
    order; an off-diagonal patch is two items of ``team / 2`` steps (first
    steps 0 and team / 2), a diagonal patch one item of steps 1..team / 2.
    In an item lane l holds row atom g T + l and at step k meets column atom
    h T + (l + k) mod T; at step T / 2 of a diagonal item only lanes l < T / 2
    take the pair, which the other half would meet again. So every
    unordered pair is met once. Each item writes one slot of each of its row
    atoms and one of each of its column atoms, numbered per group in item
    order: every atom of group g has slots 0..2G-1, each written once, and
    its owner adds them in slot order."""
    T = int(team)
    G = pair_groups(n_atoms, T)
    S = T // 2
    count = np.zeros(G, np.int64)
    items = []
    for g in range(G):
        for h in range(g, G):
            for k0 in ((1,) if g == h else (0, S)):
                sr, count[g] = count[g], count[g] + 1
                sc, count[h] = count[h], count[h] + 1
                items.append((g * T, h * T, k0 | (int(g == h) << 16), int(sr) | (int(sc) << 16)))
    return np.asarray(items, np.int32).reshape(-1, 4)


def launch_shapes(n_atoms: int) -> list:
    """Every shape the kernels take for ``n_atoms`` atoms: C in 1, 2, 4, 8
    with atoms in every CTA, L a power of two up to a warp, at most
    ``MAX_THREADS`` threads a CTA, a pair team T of 2-32 lanes, P = 1 or 2
    steps an iteration (P = 2 needs an even T / 2)."""
    n = int(n_atoms)
    shapes = [LaunchShape(C, L, T, P) for C in _CLUSTERS for L in _LANES for T in _TEAMS
              for P in (1, 2)]
    return [s for s in shapes
            if (s.cluster - 1) * s.rows(n) < n and s.steps % s.pairs == 0
            and s.threads(n) <= MAX_THREADS]


def shape_cost(n_atoms: int, s: LaunchShape) -> float:
    """The chooser's cost of a step in shape ``s``, in pair steps a lane:
    a phase's ``rounds`` items (``steps`` pair steps of ``_STEP_COST`` and
    ``_ROUND_COST`` each), each atom team's slot sums and shuffles, the
    cluster barriers."""
    n = int(n_atoms)
    return (s.rounds(n) * (s.steps * _STEP_COST[s.pairs] + _ROUND_COST)
            + _FOLD_COST * -(-s.slots(n) // s.lanes) + _SHUFFLE_COST * math.log2(s.lanes)
            + (_CLUSTER_COST if s.cluster > 1 else 0.0))


def launch_shape(n_atoms: int, n_replicas: int,
                 capacity: Callable[[LaunchShape], int]) -> LaunchShape:
    """The launch shape of ``n_replicas`` replicas of ``n_atoms`` atoms:
    of ``launch_shapes(n_atoms)``, the cheapest by ``shape_cost``, then the
    fewest CTAs and lanes, the widest pair team and one step an iteration,
    of which ``capacity(shape)`` replicas, at least ``n_replicas``, can be
    resident at once. On the card ``capacity`` is the card's own count
    (``FusedChunk._shape``), for the register budget of the shape's P. One
    CTA and one lane an atom (a thread an atom, ``LaunchShape(1, 1)``) is
    taken without asking, so no replica count is refused here; a
    cooperative launch that still cannot be resident is refused by the
    card."""
    n, R = int(n_atoms), int(n_replicas)
    if not 1 <= n <= MAX_ATOMS or R < 1:
        raise ValueError(f"need 1 <= n_atoms <= {MAX_ATOMS} and n_replicas >= 1")

    def key(s: LaunchShape):
        return (shape_cost(n, s), s.cluster, s.lanes, -s.team, s.pairs)

    return next(s for s in sorted(launch_shapes(n), key=key)
                if s == LaunchShape(1, 1) or capacity(s) >= R)


@dataclasses.dataclass
class FusedRemdOutput:
    """What one whole-run REMD launch returns, rung-major."""

    positions: torch.Tensor     # (R, N, 3) final
    velocities: torch.Tensor    # (R, N, 3) final
    seeds: torch.Tensor         # (R,) noise seeds, moved with the configurations
    frames: torch.Tensor        # (F, R, N, 3)
    frame_energy: torch.Tensor  # (F, R)
    frame_kinetic: torch.Tensor  # (F, R) kinetic energy of the state velocities
    ids_hist: torch.Tensor      # (A + 1, R) int32
    accept: torch.Tensor        # (A, R) 1 on both rungs of an accepted pair
    #: (R, F, STAMP_BOUNDARIES) int64 clock64 stamps of one sampled step a
    #: frame's block, by configuration (launched with ``stamps=True``), or None
    stamps: Optional[torch.Tensor] = None


#: each interval's index in STAMP_PHASES, by device (made once: a copy to
#: the device a segment would cost the traced runner a synchronisation)
_INTERVAL_PHASE = {}


def step_phase_cycles(stamps: torch.Tensor) -> torch.Tensor:
    """(len(STAMP_PHASES),) int64 on the stamps' device: the cycles of each
    phase summed over every sampled step of ``stamps`` (R, F,
    STAMP_BOUNDARIES); they add up to the steps' cycles from first to last
    boundary. No host synchronisation."""
    dev = stamps.device
    if dev not in _INTERVAL_PHASE:
        _INTERVAL_PHASE[dev] = torch.as_tensor(
            [STAMP_PHASES.index(p) for p in STAMP_INTERVALS], device=dev)
    d = (stamps[..., 1:] - stamps[..., :-1]).sum(dim=(0, 1))
    return torch.zeros(len(STAMP_PHASES), dtype=torch.int64, device=dev).index_add_(
        0, _INTERVAL_PHASE[dev], d)


def _bonded_csr(system: System) -> Tuple[np.ndarray, np.ndarray]:
    """``bonded_window.bonded_csr`` of the system's bonded terms."""
    return bonded_csr(system.bond_idx.cpu().numpy(), system.angle_idx.cpu().numpy(),
                      system.torsion_idx.cpu().numpy(), system.n_atoms)


class FusedChunk:
    """K-step Langevin chunk for all replicas of one system (see module
    docstring). Built by ``build_fused_chunk``."""

    def __init__(self, system: System, *, dt: float, friction: float, n_replicas: int,
                 bias: Optional[CVBias] = None, mtd: Optional[MetadynamicsBias] = None,
                 mtd_deposit_interval: Optional[int] = None):
        require_no_vsites(system, "the fused Langevin kernels")
        if system.n_atoms > MAX_ATOMS:
            raise ValueError(
                f"the fused kernels hold one replica in at most {MAX_CLUSTER} CTAs "
                f"and need one thread an atom when the replicas fill the card: "
                f"N = {system.n_atoms} exceeds {MAX_ATOMS}"
            )
        if mtd_deposit_interval is not None:
            if bias is None or bias.kind != "metadynamics" or mtd is None:
                raise ValueError(
                    "mtd_deposit_interval needs a metadynamics bias and its "
                    "MetadynamicsBias parameters")
            if int(mtd_deposit_interval) < 1:
                raise ValueError("mtd_deposit_interval must be >= 1")
        self.system = system
        self.dt = float(dt)
        self.friction = float(friction)
        self.n_replicas = int(n_replicas)
        self.bias = bias
        self.mtd = mtd
        self.mtd_deposit_interval = (
            None if mtd_deposit_interval is None else int(mtd_deposit_interval))
        self.dense = make_dense_params(system)
        p = self.dense
        n = system.n_atoms
        dev = system.device
        zeros_nn = torch.zeros((n, n), dtype=torch.float32, device=dev)
        inv_m = torch.where(p.masses > 0.0, 1.0 / p.masses, torch.zeros_like(p.masses))
        self._atom_p = torch.stack([
            inv_m, p.q, p.gb_rho, p.gb_sr, p.gb_radii,
            p.gb_alpha, p.gb_beta, p.gb_gamma, p.sa_coef,
        ]).contiguous()
        use_neck = p.use_neck
        self._pair_p = torch.stack([
            p.lj_a, p.lj_b, p.qq_scaled, p.qq_full,
            p.neck_d0 if use_neck else zeros_nn,
            p.neck_scale * p.neck_m0 if use_neck else zeros_nn,
        ]).contiguous()
        self._bond_i = system.bond_idx.to(torch.int32).contiguous()
        self._bond_p = torch.stack([p.bond_k, p.bond_r0], 1).contiguous()
        self._angle_i = system.angle_idx.to(torch.int32).contiguous()
        self._angle_p = torch.stack([p.angle_k, p.angle_t0], 1).contiguous()
        self._tors_i = system.torsion_idx.to(torch.int32).contiguous()
        self._tors_p = torch.stack([p.tor_k, p.tor_n, p.tor_phase], 1).contiguous()
        ptr, _ = _bonded_csr(system)
        _, slot = bonded_slots(system.bond_idx.cpu().numpy(), system.angle_idx.cpu().numpy(),
                               system.torsion_idx.cpu().numpy(), n)
        self._csr_host = ptr
        self._csr_ptr = torch.as_tensor(ptr, device=dev)
        self._bonded_slot = torch.as_tensor(slot, device=dev).contiguous()
        self._n_terms = {"n_bonds": int(system.bond_idx.shape[0]),
                         "n_angles": int(system.angle_idx.shape[0]),
                         "n_torsions": int(system.torsion_idx.shape[0])}
        self._use_neck = int(use_neck)
        self.c1 = math.exp(-self.friction * self.dt)
        self._bias_tables = None
        #: the hill widths as launch arguments, read from the device once
        self._mtd_inv_sigma = {}
        #: launch shapes by replica count, plans by (mode, replicas, forced
        #: shape), and the pair items and their tables by team width
        self._shapes = {}
        self._plans = {}
        self._items = {}
        #: the shape of this chunk's last launch: cluster, lanes, team,
        #: pairs, rows, threads, staged (the items' tables in shared memory),
        #: slots_smem (the slots in shared memory), smem_bytes (the base
        #: alone), resident (replicas the card holds at once as placed)
        self.last_launch: Optional[dict] = None
        if bias is not None:
            if bias.device != dev or bias.n_atoms != n:
                raise ValueError("the bias was built for another device or system")
            dptr, dent = bias.dihedral_csr()
            self._bias_tables = {
                "quads": bias.quads.to(torch.int32).contiguous(),
                "dih_ptr": torch.as_tensor(dptr, device=dev),
                "dih_ent": torch.as_tensor(dent, device=dev).contiguous(),
                "bias_p": bias.blob(),
            }
            if bias.mtd_inv_sigma is not None:
                self._mtd_inv_sigma = {
                    f"mtd_inv_sigma{k}": float(s)
                    for k, s in enumerate(bias.mtd_inv_sigma.cpu())}

    # --- plain PyTorch version ------------------------------------------------

    def _force_fn(self, hills):
        """Physical forces plus the bias twin under a fixed ledger."""
        if self.bias is None:
            return lambda y: energy_and_forces(self.dense, y)

        def force_fn(y):
            e, f = energy_and_forces(self.dense, y)
            eb, fb = self.bias.energy_and_forces(y, hills)
            return e + eb, f + fb

        return force_fn

    def _steps(self, state, temps, n_steps, force_fn, replica_offset: int = 0):
        for _ in range(int(n_steps)):
            state, _ = langevin_step(
                self.system, state, dt=self.dt, friction=self.friction,
                temperature_K=temps, force_fn=force_fn, replica_offset=replica_offset,
            )
        return state

    def reference(self, x, v, seeds, temps, n_steps: int, step_offset: int = 0,
                  hills: Optional[MetaDState] = None, replica_offset: int = 0):
        """Plain PyTorch twin: ``langevin_step`` over the analytic forces
        and the bias twin, the kernel's noise stream, energies at the final
        positions. With ``mtd_deposit_interval`` every replica deposits a
        hill after each window, in replica order, and the ledger comes
        back as a fourth value. ``replica_offset``: the global index of
        ``x``'s first replica (a rank's block of a sharded REMD)."""
        self._check(x, v, seeds, temps, n_steps, hills)
        state = MDState(positions=x, velocities=v, seeds=seeds, step=int(step_offset))
        if self.mtd_deposit_interval is None:
            force_fn = self._force_fn(hills)
            state = self._steps(state, temps, n_steps, force_fn, replica_offset)
            return state.positions, state.velocities, force_fn(state.positions)[0]
        mtd = dataclasses.replace(self.mtd, max_hills=int(hills.heights.shape[0]))
        for _ in range(int(n_steps) // self.mtd_deposit_interval):
            state = self._steps(state, temps, self.mtd_deposit_interval,
                                self._force_fn(hills))
            cvs = self.bias.cv(state.positions)
            for r in range(self.n_replicas):
                hills = mtd.deposit(hills, cvs[r])
        energies = self._force_fn(hills)(state.positions)[0]
        return state.positions, state.velocities, energies, hills

    # --- dispatch ---------------------------------------------------------------

    def __call__(self, x, v, seeds, temps, n_steps: int, step_offset: int = 0,
                 hills: Optional[MetaDState] = None):
        if x.device.type == "cpu":
            return self.reference(x, v, seeds, temps, n_steps, step_offset, hills)
        xo, vo, eo, _, ho = self._launch(x, v, seeds, temps, n_steps, step_offset,
                                         False, hills)
        if self.mtd_deposit_interval is None:
            return xo, vo, eo
        return xo, vo, eo, ho

    def energy_and_forces(self, x: torch.Tensor, hills: Optional[MetaDState] = None):
        """Energies ``(R,)`` and forces ``(R, N, 3)`` at ``x``, bias
        included: the kernel with zero steps on a CUDA tensor, the analytic
        twin on the CPU."""
        if x.device.type == "cpu":
            return self._force_fn(hills)(x)
        R = x.shape[0]
        v = torch.zeros_like(x)
        seeds = torch.zeros(R, dtype=torch.int32, device=x.device)
        temps = torch.zeros(R, dtype=torch.float32, device=x.device)
        _, _, eo, fo, _ = self._launch(x, v, seeds, temps, 0, 0, True, hills,
                                       deposits=False)
        return eo, fo

    def _check(self, x, v, seeds, temps, n_steps, hills=None):
        n = self.system.n_atoms
        if x.dim() != 3 or tuple(x.shape[1:]) != (n, 3):
            raise ValueError(f"x must be (R, {n}, 3), got {tuple(x.shape)}")
        R = x.shape[0]
        if R != self.n_replicas:
            raise ValueError(f"chunk built for {self.n_replicas} replicas, got {R}")
        if v.shape != x.shape:
            raise ValueError(f"v {tuple(v.shape)} must match x {tuple(x.shape)}")
        if tuple(seeds.shape) != (R,) or tuple(temps.shape) != (R,):
            raise ValueError("seeds and temps must be (R,)")
        if x.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("x and v must be float32")
        if seeds.dtype != torch.int32:
            raise TypeError("seeds must be int32")
        if int(n_steps) < 0:
            raise ValueError("n_steps must be >= 0")
        for t in (v, seeds, temps):
            if t.device != x.device:
                raise ValueError("x, v, seeds and temps must share one device")
        if x.device != self.system.device:
            raise ValueError(
                f"tensors on {x.device} but the chunk was built for "
                f"{self.system.device}"
            )
        needs_hills = self.bias is not None and self.bias.kind == "metadynamics"
        if needs_hills != (hills is not None):
            raise ValueError(
                "the hills ledger is passed to a metadynamics chunk, and only to one")
        if hills is not None:
            H = hills.heights.shape[0]
            if tuple(hills.centers.shape) != (H, self.bias.n_cv):
                raise ValueError(
                    f"hills.centers must be ({H}, {self.bias.n_cv}), got "
                    f"{tuple(hills.centers.shape)}")
            if hills.centers.device != x.device:
                raise ValueError("the hills ledger must lie on the device of x")
        if (self.mtd_deposit_interval is not None
                and int(n_steps) % self.mtd_deposit_interval != 0):
            raise ValueError("n_steps must be a multiple of mtd_deposit_interval")

    # --- the kernel ---------------------------------------------------------------

    def item_tables(self, team: int):
        """``pair_items(N, team)`` on the chunk's device and the pair
        tables in item order, ``(items, PAIR_TABS, team / 2, team)``: entry
        (t, s, l) of an item is table t of the pair lane l meets at its step
        s (0 where the lane takes no pair). The values are the (N, N)
        tables' own, so the kernel reads what the plain version reads."""
        T = int(team)
        if T not in self._items:
            n = self.system.n_atoms
            dev = self.system.device
            items = pair_items(n, T)
            it = torch.as_tensor(items, dtype=torch.int64, device=dev)
            S = T // 2
            lane = torch.arange(T, device=dev)[None, None, :]
            kk = (it[:, 2] & 0xFFFF)[:, None, None] + torch.arange(S, device=dev)[None, :, None]
            i = it[:, 0, None, None] + lane
            j = it[:, 1, None, None] + (lane + kk) % T
            diag = (it[:, 2] >> 16).bool()[:, None, None]
            ok = (i < n) & (j < n) & (~diag | (kk < T // 2) | (lane < T // 2))
            i, j = torch.where(ok, i, 0), torch.where(ok, j, 0)
            p = self._pair_p
            tab = torch.cat([p[:, i, j], p[4:6, j, i]])          # (8, items, S, T)
            tab = (tab * ok).permute(1, 0, 2, 3).contiguous()
            self._items[T] = (torch.as_tensor(items, device=dev).contiguous(), tab)
        return self._items[T]

    def _common_args(self, R: int, n_steps: int):
        """Pointer, integer and float arguments every mode shares."""
        n = self.system.n_atoms
        ptrs = {
            "atom_p": self._atom_p,
            "bond_i": self._bond_i, "bond_p": self._bond_p,
            "angle_i": self._angle_i, "angle_p": self._angle_p,
            "tors_i": self._tors_i, "tors_p": self._tors_p,
            "csr_ptr": self._csr_ptr, "bonded_slot": self._bonded_slot,
        }
        ints = {
            "n_replicas": R, "n_atoms": n, "n_steps": int(n_steps),
            "use_gb": int(self.dense.use_gb), "use_neck": self._use_neck, **self._n_terms,
        }
        floats = {
            "dt": self.dt, "half_dt": 0.5 * self.dt, "c1": self.c1,
            "c2sq": 1.0 - self.c1 * self.c1, "gb_pref": self.dense.gb_pref,
        }
        b = self.bias
        if b is not None:
            ptrs.update(self._bias_tables)
            ints.update({
                "bias_kind": _BIAS_KINDS[b.kind], "n_dih": b.n_dihedrals,
                "n_layers": len(b.weights), "n_cv": b.n_cv,
                "use_whiten": int(b.wmat is not None),
                "bias_p_len": int(self._bias_tables["bias_p"].numel()),
            })
            ints.update({f"width{l}": w for l, w in enumerate(b.widths)})
            floats["bias_strength"] = b.strength
            floats.update(self._mtd_inv_sigma)
        return ptrs, ints, floats

    def _plan_of(self, mode: int, ints, shape: LaunchShape) -> dict:
        """The card's numbers for one launch shape (``_PLAN``)."""
        iv = (ctypes.c_int * len(_INTS))(*[int(ints.get(k, 0)) for k in _INTS])
        out = (ctypes.c_int * len(_PLAN))()
        for k in ("cluster", "lanes", "team", "pairs"):
            iv[_INTS.index(k)] = getattr(shape, k)
        iv[_INTS.index("bonded_ld")] = self._bonded_ld(shape)
        _kernels.check_launch(_library().pmarlo_fused_md_plan(mode, iv, out),
                              f"fused_md plan {shape}")
        return dict(zip(_PLAN, out))

    def _bonded_ld(self, shape: LaunchShape) -> int:
        """Bonded incidences of the atoms one CTA of ``shape`` owns, at most:
        the length of the bonded slots in a CTA's slot block."""
        n, r, ptr = self.system.n_atoms, shape.rows(self.system.n_atoms), self._csr_host
        return max(int(ptr[min(n, (k + 1) * r)] - ptr[min(n, k * r)])
                   for k in range(shape.cluster))

    def _shape(self, ints) -> LaunchShape:
        """The launch shape of every mode for this many replicas, chosen
        once: one shape, so that the windowed path (the chunk kernel) and
        the whole-run path (the REMD kernel) sum in one order and stay
        bitwise equal. ``launch_shape`` chooses by the card's count of
        resident replicas of each shape (its slots and tables in global
        memory where that holds more), the lower of the two kernels'."""
        R = int(ints["n_replicas"])
        if R not in self._shapes:
            modes = (_MODE_CHUNK, _MODE_FUSED_REMD)
            self._shapes[R] = launch_shape(
                self.system.n_atoms, R,
                lambda s: min(self._plan_of(m, ints, s)["resident"] for m in modes))
        return self._shapes[R]

    def _plan(self, mode: int, ints, shape: Optional[LaunchShape] = None) -> dict:
        """Launch shape and placement of ``mode`` for this many replicas
        (``shape`` forces one). The slots, and then the items' tables, go to
        shared memory where they fit and do not leave fewer replicas
        resident than there are (or than with neither); the placement
        moves no sum, so it does not change the arithmetic."""
        R = int(ints["n_replicas"])
        key = (mode, R, shape)
        if key not in self._plans:
            if shape is None:
                shape = self._shape(ints)
            plan = self._plan_of(mode, ints, shape)
            need = min(R, plan["resident"])
            slots_smem = plan["resident_slots"] >= need
            staged = slots_smem and plan["resident_all"] >= need
            placed = "resident_all" if staged else "resident_slots" if slots_smem else "resident"
            self._plans[key] = {**dataclasses.asdict(shape),
                                "rows": shape.rows(self.system.n_atoms),
                                "threads": plan["threads"], "staged": staged,
                                "slots_smem": slots_smem, "smem_bytes": plan["smem_bytes"],
                                "resident": plan[placed]}
        return self._plans[key]

    def _run(self, mode: int, what: str, ptrs, ints, floats, step_offset: int,
             attempt_offset: int, device, shape: Optional[LaunchShape] = None) -> None:
        lib = _library()
        with torch.cuda.device(device):
            plan = self._plan(mode, ints, shape)
            sh = LaunchShape(plan["cluster"], plan["lanes"], plan["team"], plan["pairs"])
            ints = {**ints, **{k: int(plan[k]) for k in (
                "cluster", "lanes", "team", "pairs", "staged", "slots_smem")},
                "bonded_ld": self._bonded_ld(sh)}
            items, tab = self.item_tables(plan["team"])
            ptrs = {**ptrs, "items": items, "item_tab": tab}
            if not plan["slots_smem"]:
                n = self.system.n_atoms
                per_cta = 3 * sh.slots(n) * sh.rows(n) + 3 * ints["bonded_ld"]
                ptrs["slot_scratch"] = torch.empty(
                    ints["n_replicas"] * sh.cluster * per_cta, dtype=torch.float32,
                    device=device)
            pv = (ctypes.c_void_p * len(_PTRS))(*[
                ptrs[k].data_ptr() if ptrs.get(k) is not None else None for k in _PTRS])
            iv = (ctypes.c_int * len(_INTS))(*[int(ints.get(k, 0)) for k in _INTS])
            fv = (ctypes.c_float * len(_FLOATS))(*[
                float(floats.get(k, 0.0)) for k in _FLOATS])
            stream = torch.cuda.current_stream(device).cuda_stream
            with (profiling.span("remd.launch") if mode == _MODE_FUSED_REMD
                  else contextlib.nullcontext()):
                rc = lib.pmarlo_fused_md_launch(
                    mode, pv, iv, fv, int(step_offset), int(attempt_offset), stream)
        self.last_launch = plan
        if rc == _TOO_LARGE:
            raise RuntimeError(
                f"{what}: {ints['n_replicas']} replicas of {ints['n_atoms']} atoms "
                "cannot all be resident on this card at once, and the kernel's "
                "grid barrier needs them to be; run fewer replicas per launch")
        _kernels.check_launch(rc, what)

    def _launch(self, x, v, seeds, temps, n_steps, step_offset, want_forces,
                hills=None, deposits=True, shape: Optional[LaunchShape] = None):
        global launches
        if x.device.type != "cuda":
            raise RuntimeError(f"the fused kernel runs on CUDA tensors, got {x.device}")
        self._check(x, v, seeds, temps, 0 if not deposits else n_steps, hills)
        R = x.shape[0]
        dev = x.device
        xo = x.contiguous().clone()
        vo = v.contiguous().clone()
        eo = torch.empty(R, dtype=torch.float32, device=dev)
        fo = torch.empty_like(xo) if want_forces else None
        kT = (BOLTZMANN_CONSTANT_KJ_PER_MOL * temps.to(torch.float32)).contiguous()
        ptrs, ints, floats = self._common_args(R, n_steps)
        ptrs.update({"x": xo, "v": vo, "energy": eo, "forces": fo,
                     "seeds": seeds.contiguous(), "kT": kT})
        fused = deposits and self.mtd_deposit_interval is not None
        ho = None
        if hills is not None:
            # the fused mode writes the ledger: it works on a copy
            ho = MetaDState(
                centers=hills.centers.to(torch.float32).contiguous().clone(),
                heights=hills.heights.to(torch.float32).contiguous().clone(),
                n_hills=hills.n_hills.to(torch.int32).reshape(1).clone(),
            )
            ptrs.update({"mtd_centers": ho.centers, "mtd_heights": ho.heights,
                         "mtd_count": ho.n_hills})
            ints["mtd_capacity"] = int(ho.heights.shape[0])
        if fused:
            mtd = self.mtd
            ptrs["cv_buf"] = torch.empty((R, self.bias.n_cv), dtype=torch.float32, device=dev)
            ints["mtd_interval"] = self.mtd_deposit_interval
            floats["mtd_height"] = float(mtd.height)
            if mtd.bias_factor is not None:
                if mtd.bias_factor <= 1.0:
                    raise ValueError("bias_factor must be > 1")
                floats["mtd_kb_dt"] = (BOLTZMANN_CONSTANT_KJ_PER_MOL
                                       * (mtd.bias_factor - 1.0) * mtd.temperature_K)
        name = ("fused_metadynamics" if fused
                else "chunk" if self.bias is None else f"bias_{self.bias.kind}")
        self._run(_MODE_FUSED_MTD if fused else _MODE_CHUNK, f"fused_md {name}",
                  ptrs, ints, floats, step_offset, 0, dev, shape)
        if name == "chunk":
            launches += 1
        else:
            variant_launches[name] += 1
        if ho is not None:
            ho = dataclasses.replace(ho, n_hills=ho.n_hills.reshape(()))
        return xo, vo, eo, fo, ho

    def plan_remd(self, n_replicas: int) -> dict:
        """The whole-run launch's shape and placement for ``n_replicas``
        (``last_launch``'s keys), chosen now rather than at the first
        launch; the launch takes the same plan."""
        dev = self.system.device
        if dev.type != "cuda":
            raise RuntimeError(f"the fused kernel runs on CUDA tensors, got {dev}")
        _library()
        with torch.cuda.device(dev):
            return self._plan(_MODE_FUSED_REMD, self._common_args(int(n_replicas), 0)[1])

    def remd(self, x, v, seeds, ids, ladder, *, n_attempts: int,
             frames_per_attempt: int, report_interval: int, step_offset: int,
             swap_seed: int, attempt_offset: int, stamps: bool = False) -> FusedRemdOutput:
        """The whole REMD run in one launch (``build_pallas_remd``):
        ``n_attempts`` windows of ``frames_per_attempt`` blocks of
        ``report_interval`` steps, a frame and its energies after each
        block, a parity-alternating neighbour Metropolis swap after each
        window (parity = the window's index in this call; the uniform of
        pair ``p`` at global attempt ``attempt_offset + a`` is
        ``remd.swap_uniforms``'s). Inputs and outputs are rung-major.
        ``stamps=True`` launches the stamped build (the same bits, and the
        step-phase stamps in ``FusedRemdOutput.stamps``). CUDA tensors
        only: the plain version is
        ``ReplicaExchange._run_fused_reference``."""
        if x.device.type != "cuda":
            raise RuntimeError(f"the fused kernel runs on CUDA tensors, got {x.device}")
        if self.bias is not None and self.bias.kind != "harmonic":
            raise ValueError("fused REMD takes the harmonic CV bias only")
        self._check(x, v, seeds, ladder, 0)
        R, n = x.shape[0], self.system.n_atoms
        dev = x.device
        A, fpc = int(n_attempts), int(frames_per_attempt)
        if A < 1 or fpc < 1 or int(report_interval) < 1:
            raise ValueError("n_attempts, frames_per_attempt, report_interval must be >= 1")
        if tuple(ids.shape) != (R,) or ids.dtype != torch.int32:
            raise ValueError("ids must be (R,) int32")
        f32 = dict(dtype=torch.float32, device=dev)
        ladder = ladder.to(torch.float32).contiguous()
        out = FusedRemdOutput(
            positions=torch.empty((R, n, 3), **f32),
            velocities=torch.empty((R, n, 3), **f32),
            seeds=torch.empty(R, dtype=torch.int32, device=dev),
            frames=torch.empty((A * fpc, R, n, 3), **f32),
            frame_energy=torch.empty((A * fpc, R), **f32),
            frame_kinetic=torch.empty((A * fpc, R), **f32),
            ids_hist=torch.empty((A + 1, R), dtype=torch.int32, device=dev),
            accept=torch.empty((A, R), **f32),
            stamps=(torch.empty((R, A * fpc, STAMP_BOUNDARIES), dtype=torch.int64, device=dev)
                    if stamps else None),
        )
        out.ids_hist[0] = ids
        ptrs, ints, floats = self._common_args(R, A * fpc * int(report_interval))
        ptrs.update({
            "x": x.contiguous(), "v": v.contiguous(), "seeds": seeds.contiguous(),
            "kT": (BOLTZMANN_CONSTANT_KJ_PER_MOL * ladder).contiguous(),
            "ladder": ladder,
            "betas": (1.0 / (BOLTZMANN_CONSTANT_KJ_PER_MOL * ladder)).contiguous(),
            "ids0": ids.contiguous(),
            "x_out": out.positions, "v_out": out.velocities, "seeds_out": out.seeds,
            "frames": out.frames, "frame_e": out.frame_energy,
            "frame_ke": out.frame_kinetic, "ids_hist": out.ids_hist,
            "accept": out.accept,
            "swap_e": torch.empty((2, R), **f32),
            "stamps": out.stamps,
        })
        ints.update({"n_attempts": A, "frames_per_attempt": fpc,
                     "report_interval": int(report_interval),
                     "swap_seed": int(swap_seed) & 0x7FFFFFFF})
        self._run(_MODE_FUSED_REMD, "fused_md fused_remd", ptrs, ints, floats,
                  step_offset, attempt_offset, dev)
        variant_launches["fused_remd"] += 1
        return out


def build_fused_chunk(
    system: System, *, dt: float, friction: float, n_replicas: int,
    bias_model=None, bias_quads=None, bias_strength: float = 1.0,
    bias_kind: str = "harmonic", mtd_sigma=None,
    mtd_deposit_interval: Optional[int] = None, mtd_height: float = 1.0,
    mtd_bias_factor: Optional[float] = None, mtd_temperature_K: float = 300.0,
) -> FusedChunk:
    """The fused chunk for ``system`` (tensors on ``system.device``), with
    the keywords of ``build_pallas_chunk``: ``bias_model`` (a
    ``DeepTICAModel``) and ``bias_quads`` put the CV bias into the kernel,
    ``bias_kind="metadynamics"`` with ``mtd_sigma`` reads a hills ledger
    passed at call time, and ``mtd_deposit_interval`` moves the deposits
    into the launch."""
    bias = mtd = None
    if bias_model is not None:
        if bias_quads is None:
            raise ValueError("bias_model requires bias_quads (dihedral atom quadruples)")
        bias = CVBias(bias_model, bias_quads, n_atoms=system.n_atoms,
                      strength=bias_strength, kind=bias_kind, mtd_sigma=mtd_sigma,
                      device=system.device)
        if bias_kind == "metadynamics":
            mtd = MetadynamicsBias(
                sigma=tuple(float(s) for s in np.asarray(mtd_sigma, np.float64)),
                height=float(mtd_height), bias_factor=mtd_bias_factor,
                temperature_K=float(mtd_temperature_K))
    return FusedChunk(system, dt=dt, friction=friction, n_replicas=n_replicas,
                      bias=bias, mtd=mtd, mtd_deposit_interval=mtd_deposit_interval)


def grid_barrier_probe(n_blocks: int, n_threads: int, n_barriers: int,
                       device="cuda", cluster: int = 1) -> None:
    """Launch ``n_blocks`` CTAs of ``n_threads`` threads, in clusters of
    ``cluster``, that meet at ``n_barriers`` grid barriers and do nothing
    else: timed with and without barriers, it gives the cost of the barrier
    the fused REMD and fused metadynamics kernels synchronise their
    replicas with (and shows whether the card takes a cooperative launch of
    clusters)."""
    rc = _library().pmarlo_grid_barrier_probe(
        int(n_blocks), int(n_threads), int(n_barriers), int(cluster),
        torch.cuda.current_stream(torch.device(device)).cuda_stream)
    _kernels.check_launch(rc, "grid_barrier_probe")


__all__ = ["FusedChunk", "FusedRemdOutput", "LaunchShape", "build_fused_chunk",
           "grid_barrier_probe", "launch_shape", "launch_shapes", "pair_items",
           "shape_cost", "step_phase_cycles", "MAX_ATOMS", "MAX_CLUSTER", "MAX_THREADS",
           "PAIR_TABS", "STAMP_BOUNDARIES", "STAMP_INTERVALS", "STAMP_PHASES", "launches",
           "variant_launches"]
