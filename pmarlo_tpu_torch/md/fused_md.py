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
  cluster of ``C`` CTAs and each atom's row a team of ``L`` lanes;
  ``launch_shape`` chooses both from the atom and replica counts and the
  card.
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

import ctypes
import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..bias.metadynamics import MetadynamicsBias, MetaDState
from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from .analytic import energy_and_forces, make_dense_params
from .bonded_window import bonded_csr
from .cv_bias import MAX_CV, MAX_LAYERS, CVBias
from .integrate import MDState, langevin_step
from .system import System

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

#: atoms per replica the kernels take: with one lane a row and one CTA a
#: replica (the shape every replica count falls back to) a CTA has one
#: thread an atom, and one SM's register file holds 512 threads at the
#: kernels' register bound
MAX_ATOMS = 512
#: threads a CTA and CTAs a replica (a thread-block cluster) at most
MAX_THREADS = 512
MAX_CLUSTER = 8
_CLUSTERS = (1, 2, 4, 8)
_LANES = (1, 2, 4, 8, 16, 32)
#: cost model of the chooser, in partners a lane visits a step: one level of
#: the row team's shuffle sum, and the cluster barriers and copies of a step
#: (chip_smoke.py's shape sweeps on an H100: a partner a lane costs 2.4-2.8 us
#: a step over the three GB phases, a cluster of 2-8 CTAs 3.4-5.5 us more)
_SHUFFLE_COST = 0.25
_CLUSTER_COST = 1.5

# argument order of pmarlo_fused_md_launch (the enums of csrc/fused_md.cu)
_PTRS = (
    "x", "v", "energy", "forces", "seeds", "kT", "atom_p", "pair_p", "bond_i",
    "bond_p", "angle_i", "angle_p", "tors_i", "tors_p", "csr_ptr", "csr_ent",
    "quads", "dih_ptr", "dih_ent", "bias_p", "mtd_centers", "mtd_heights",
    "mtd_count", "cv_buf", "x_out", "v_out", "seeds_out", "ladder",
    "betas", "ids0", "frames", "frame_e", "frame_ke", "ids_hist", "accept",
    "swap_e",
)
_INTS = (
    "n_replicas", "n_atoms", "n_steps", "use_gb", "use_neck", "bias_kind",
    "n_dih", "n_layers", *(f"width{l}" for l in range(MAX_LAYERS + 1)),
    "n_cv", "use_whiten", "bias_p_len", "mtd_capacity", "mtd_interval",
    "n_attempts", "frames_per_attempt", "report_interval", "swap_seed",
    "cluster", "lanes", "staged",
)
_FLOATS = (
    "dt", "half_dt", "c1", "c2sq", "gb_pref", "bias_strength", "mtd_height",
    "mtd_kb_dt", *(f"mtd_inv_sigma{k}" for k in range(MAX_CV)),
)
_MODE_CHUNK, _MODE_FUSED_MTD, _MODE_FUSED_REMD = 0, 1, 2
# what pmarlo_fused_md_plan writes
_PLAN = ("threads", "smem_bytes", "stageable", "resident", "resident_staged")
_BIAS_KINDS = {"harmonic": 1, "metadynamics": 2}
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
        abi = [lib.pmarlo_fused_md_abi(k) for k in range(8)]
        if abi != [len(_PTRS), len(_INTS), len(_FLOATS), MAX_LAYERS, MAX_CV,
                   MAX_THREADS, MAX_CLUSTER, len(_PLAN)]:
            raise RuntimeError(
                f"kernel library and wrapper disagree on the argument lists: {abi}")
        _configured = True
    return lib


@dataclasses.dataclass(frozen=True)
class LaunchShape:
    """How the kernels lay out one replica of ``n`` atoms: a cluster of
    ``cluster`` CTAs, CTA k owning rows ``[k rows(n), (k + 1) rows(n))``,
    each row a team of ``lanes`` lanes of one warp, ``threads(n)`` threads
    a CTA (``shape_of`` in ``csrc/fused_md.cu`` derives the same)."""

    cluster: int
    lanes: int

    def rows(self, n_atoms: int) -> int:
        return -(-int(n_atoms) // self.cluster)

    def threads(self, n_atoms: int) -> int:
        return -(-self.rows(n_atoms) * self.lanes // 32) * 32


def launch_shapes(n_atoms: int) -> list:
    """Every shape the kernels take for ``n_atoms`` atoms: C in 1, 2, 4, 8
    with rows in every CTA, L a power of two up to a warp, at most
    ``MAX_THREADS`` threads a CTA."""
    n = int(n_atoms)
    shapes = [LaunchShape(C, L) for C in _CLUSTERS for L in _LANES]
    return [s for s in shapes
            if (s.cluster - 1) * s.rows(n) < n and s.threads(n) <= MAX_THREADS]


def launch_shape(n_atoms: int, n_replicas: int,
                 capacity: Callable[[LaunchShape], int]) -> LaunchShape:
    """The launch shape of ``n_replicas`` replicas of ``n_atoms`` atoms:
    of ``launch_shapes(n_atoms)``, the one with the fewest partners a lane
    visits a step (``_SHUFFLE_COST`` a shuffle level, ``_CLUSTER_COST`` for
    more than one CTA), then the fewest CTAs and lanes, of which
    ``capacity(shape)`` replicas, at least ``n_replicas``, can be resident
    at once. On the card ``capacity`` is the card's own count
    (``FusedChunk._shape``). One CTA and one lane a row (a thread an atom)
    is taken without asking, so no replica count is refused here; a
    cooperative launch that still cannot be resident is refused by the
    card."""
    n, R = int(n_atoms), int(n_replicas)
    if not 1 <= n <= MAX_ATOMS or R < 1:
        raise ValueError(f"need 1 <= n_atoms <= {MAX_ATOMS} and n_replicas >= 1")

    def cost(s: LaunchShape):
        return (-(-n // s.lanes) + _SHUFFLE_COST * math.log2(s.lanes)
                + (_CLUSTER_COST if s.cluster > 1 else 0.0), s.cluster, s.lanes)

    return next(s for s in sorted(launch_shapes(n), key=cost)
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
        ptr, ent = _bonded_csr(system)
        self._csr_ptr = torch.as_tensor(ptr, device=dev)
        self._csr_ent = torch.as_tensor(ent, device=dev).contiguous()
        self._use_neck = int(use_neck)
        self.c1 = math.exp(-self.friction * self.dt)
        self._bias_tables = None
        #: the hill widths as launch arguments, read from the device once
        self._mtd_inv_sigma = {}
        #: launch shapes by replica count, and plans by (mode, replicas,
        #: forced shape)
        self._shapes = {}
        self._plans = {}
        #: the shape of this chunk's last launch: cluster, lanes, rows,
        #: threads, staged (pair tables in shared memory), smem_bytes (without
        #: the tables), resident (replicas the card holds at once)
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

    def _steps(self, state, temps, n_steps, force_fn):
        for _ in range(int(n_steps)):
            state, _ = langevin_step(
                self.system, state, dt=self.dt, friction=self.friction,
                temperature_K=temps, force_fn=force_fn,
            )
        return state

    def reference(self, x, v, seeds, temps, n_steps: int, step_offset: int = 0,
                  hills: Optional[MetaDState] = None):
        """Plain PyTorch twin: ``langevin_step`` over the analytic forces
        and the bias twin, the kernel's noise stream, energies at the final
        positions. With ``mtd_deposit_interval`` every replica deposits a
        hill after each window, in replica order, and the ledger comes
        back as a fourth value."""
        self._check(x, v, seeds, temps, n_steps, hills)
        state = MDState(positions=x, velocities=v, seeds=seeds, step=int(step_offset))
        if self.mtd_deposit_interval is None:
            force_fn = self._force_fn(hills)
            state = self._steps(state, temps, n_steps, force_fn)
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

    def _common_args(self, R: int, n_steps: int):
        """Pointer, integer and float arguments every mode shares; the
        tensors in ``keep`` must outlive the launch call."""
        n = self.system.n_atoms
        ptrs = {
            "atom_p": self._atom_p, "pair_p": self._pair_p,
            "bond_i": self._bond_i, "bond_p": self._bond_p,
            "angle_i": self._angle_i, "angle_p": self._angle_p,
            "tors_i": self._tors_i, "tors_p": self._tors_p,
            "csr_ptr": self._csr_ptr, "csr_ent": self._csr_ent,
        }
        ints = {
            "n_replicas": R, "n_atoms": n, "n_steps": int(n_steps),
            "use_gb": int(self.dense.use_gb), "use_neck": self._use_neck,
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
        iv[_INTS.index("cluster")] = shape.cluster
        iv[_INTS.index("lanes")] = shape.lanes
        _kernels.check_launch(_library().pmarlo_fused_md_plan(mode, iv, out),
                              f"fused_md plan {shape}")
        return dict(zip(_PLAN, out))

    def _shape(self, ints) -> LaunchShape:
        """The launch shape of every mode for this many replicas, chosen
        once: one shape, so that the windowed path (the chunk kernel) and
        the whole-run path (the REMD kernel) sum in one order and stay
        bitwise equal. ``launch_shape`` chooses by the card's count of
        resident replicas of each shape, the lower of the two kernels'."""
        R = int(ints["n_replicas"])
        if R not in self._shapes:
            modes = (_MODE_CHUNK, _MODE_FUSED_REMD)
            self._shapes[R] = launch_shape(
                self.system.n_atoms, R,
                lambda s: min(self._plan_of(m, ints, s)["resident"] for m in modes))
        return self._shapes[R]

    def _plan(self, mode: int, ints, shape: Optional[LaunchShape] = None) -> dict:
        """Launch shape and table placement of ``mode`` for this many
        replicas (``shape`` forces one). The tables go to shared memory
        where they fit and do not leave fewer replicas resident than there
        are (or than without); staging reads the same numbers, so it does
        not change the arithmetic."""
        R = int(ints["n_replicas"])
        key = (mode, R, shape)
        if key not in self._plans:
            if shape is None:
                shape = self._shape(ints)
            plan = self._plan_of(mode, ints, shape)
            staged = bool(plan["stageable"]) and (
                plan["resident_staged"] >= min(R, plan["resident"]))
            self._plans[key] = {**dataclasses.asdict(shape),
                                "rows": shape.rows(self.system.n_atoms),
                                "threads": plan["threads"], "staged": staged,
                                "smem_bytes": plan["smem_bytes"],
                                "resident": plan["resident_staged" if staged else "resident"]}
        return self._plans[key]

    def _run(self, mode: int, what: str, ptrs, ints, floats, step_offset: int,
             attempt_offset: int, device, shape: Optional[LaunchShape] = None) -> None:
        lib = _library()
        with torch.cuda.device(device):
            plan = self._plan(mode, ints, shape)
            ints = {**ints, "cluster": plan["cluster"], "lanes": plan["lanes"],
                    "staged": int(plan["staged"])}
            pv = (ctypes.c_void_p * len(_PTRS))(*[
                ptrs[k].data_ptr() if ptrs.get(k) is not None else None for k in _PTRS])
            iv = (ctypes.c_int * len(_INTS))(*[int(ints.get(k, 0)) for k in _INTS])
            fv = (ctypes.c_float * len(_FLOATS))(*[
                float(floats.get(k, 0.0)) for k in _FLOATS])
            stream = torch.cuda.current_stream(device).cuda_stream
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

    def remd(self, x, v, seeds, ids, ladder, *, n_attempts: int,
             frames_per_attempt: int, report_interval: int, step_offset: int,
             swap_seed: int, attempt_offset: int) -> FusedRemdOutput:
        """The whole REMD run in one launch (``build_pallas_remd``):
        ``n_attempts`` windows of ``frames_per_attempt`` blocks of
        ``report_interval`` steps, a frame and its energies after each
        block, a parity-alternating neighbour Metropolis swap after each
        window (parity = the window's index in this call; the uniform of
        pair ``p`` at global attempt ``attempt_offset + a`` is
        ``remd.swap_uniforms``'s). Inputs and outputs are rung-major. CUDA
        tensors only: the plain version is
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
           "grid_barrier_probe", "launch_shape", "launch_shapes", "MAX_ATOMS",
           "MAX_CLUSTER", "MAX_THREADS", "launches", "variant_launches"]
