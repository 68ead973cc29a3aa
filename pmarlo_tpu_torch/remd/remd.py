"""Replica-exchange MD with replicas as the leading tensor dimension.

Port of ``pmarlo_tpu/remd/remd.py`` (the implicit-solvent dense path).
State is rung-major: slot r always holds the configuration simulating at
``ladder[r]``, so per-rung trajectories are demuxed by construction, and the
replica-identity permutation is recorded for per-walker views. Exchanges
are parity-alternating neighbour Metropolis swaps with velocity rescaling
by sqrt(T_new / T_old).

Each exchange window is one chunk call (``md/fused_md.py``): with
``use_kernel=True`` on a CUDA device that is one launch of the fused CUDA
kernel, otherwise the plain PyTorch twin. Frames go into an ``(F, R, N, 3)``
buffer preallocated on the device and are copied to the host once per
``run()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import (
    BOLTZMANN_CONSTANT_KJ_PER_MOL,
    DEFAULT_FRICTION_PER_PS,
    DEFAULT_TIMESTEP_PS,
    REMD_DEFAULT_EXCHANGE_FREQUENCY,
)
from ..md.fused_md import build_fused_chunk
from ..md.integrate import MDState, initialize_velocities, remove_com_motion
from ..md.minimize import minimize_energy
from ..md.system import System
from ..utils.input_parsing import parse_temperature_ladder


@dataclasses.dataclass(frozen=True)
class RemdConfig:
    """(reference CHANGELOG.md:126 RemdConfig)."""

    temperatures: Tuple[float, ...] = ()
    n_replicas: int = 32
    t_min: float = 300.0
    t_max: float = 450.0
    exchange_frequency: int = REMD_DEFAULT_EXCHANGE_FREQUENCY
    dt_ps: float = DEFAULT_TIMESTEP_PS
    friction_per_ps: float = DEFAULT_FRICTION_PER_PS
    heating_steps: int = 0          # linear ramp T_min -> ladder
    equilibration_steps: int = 0    # no-exchange phase at target temperatures
    report_interval: int = 100
    #: "f32" (exact) or "i16" (XTC-style fixed point at 1e-3 nm, quantized
    #: on the device; out-of-range values poison to INT16_MIN)
    frame_precision: str = "f32"
    seed: int = 2024

    def ladder(self) -> np.ndarray:
        if self.temperatures:
            return np.asarray(parse_temperature_ladder(list(self.temperatures)))
        return np.asarray(
            parse_temperature_ladder(f"{self.t_min}:{self.t_max}:{self.n_replicas}")
        )

    def __post_init__(self):
        if self.exchange_frequency < 1:
            raise ValueError("exchange_frequency must be >= 1")
        if self.exchange_frequency % self.report_interval != 0:
            raise ValueError(
                "report_interval must divide exchange_frequency "
                f"(got {self.report_interval} vs {self.exchange_frequency})"
            )
        if self.frame_precision not in ("f32", "i16"):
            raise ValueError(
                f"frame_precision must be f32|i16, got {self.frame_precision!r}"
            )


@dataclasses.dataclass
class RemdResult:
    """Host outputs of one REMD run."""

    positions: np.ndarray          # (F, R, N, 3) rung-major (demuxed) frames
    potential_energy: np.ndarray   # (F, R)
    temperatures: np.ndarray       # (R,) ladder
    replica_ids: np.ndarray        # (A+1, R) configuration identity per rung
    acceptance_matrix: np.ndarray  # (R-1,) per-neighbour-pair acceptance rate
    exchange_attempts: int
    n_steps: int
    dt_ps: float
    #: frames recorded per exchange attempt (0: unknown, estimate)
    frames_per_attempt: int = 0

    @property
    def mean_acceptance(self) -> float:
        return float(np.nanmean(self.acceptance_matrix))

    def demuxed_trajectory(self, rung: int) -> np.ndarray:
        """Constant-temperature trajectory at ladder[rung]."""
        return self.positions[:, rung]

    def replica_trajectory(self, replica: int) -> np.ndarray:
        """Continuous-configuration trajectory of one walker, reconstructed
        from the identity history."""
        n_attempts = self.replica_ids.shape[0] - 1
        n_frames = self.positions.shape[0]
        fpc = self.frames_per_attempt
        if fpc <= 0:
            fpc = max(n_frames // max(n_attempts, 1), 1)
        frames = []
        for f in range(n_frames):
            # frames of attempt-chunk a precede that chunk's closing swap
            a = min(f // fpc, n_attempts - 1) if n_attempts > 0 else 0
            rung = int(np.where(self.replica_ids[a] == replica)[0][0])
            frames.append(self.positions[f, rung])
        return np.asarray(frames)


class ReplicaExchange:
    """Replica-exchange runner.

    Usage::

        remd = ReplicaExchange(system, positions, RemdConfig(n_replicas=32),
                               device="cuda", use_kernel=True)
        result = remd.run(20_000)
    """

    def __init__(
        self,
        system: System,
        positions: torch.Tensor,
        config: RemdConfig,
        *,
        device,
        use_kernel: bool = False,
        minimize: bool = True,
    ):
        """``use_kernel=True`` runs every window through the fused CUDA
        kernel, which needs ``device`` to be a CUDA device; ``False`` runs
        the plain PyTorch twin on ``device``."""
        self.device = torch.device(device)
        if use_kernel and self.device.type != "cuda":
            raise ValueError(
                f"use_kernel=True needs a CUDA device, got {self.device}"
            )
        self.system = system.to(self.device)
        self.config = config
        self.use_kernel = use_kernel
        self.ladder = torch.as_tensor(
            config.ladder(), dtype=torch.float32, device=self.device
        )
        self.n_replicas = int(self.ladder.shape[0])
        self._chunk = build_fused_chunk(
            self.system, dt=config.dt_ps, friction=config.friction_per_ps,
            n_replicas=self.n_replicas,
        )
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(config.seed))
        x = positions.to(device=self.device, dtype=torch.float32)
        if minimize:
            x, _ = minimize_energy(self.system, x)
        x0 = x[None].expand((self.n_replicas,) + tuple(x.shape)).contiguous()
        v0 = remove_com_motion(
            self.system, initialize_velocities(self.system, gen, self.ladder)
        )
        seeds = torch.randint(
            0, 2**31 - 1, (self.n_replicas,), generator=gen,
            device=self.device, dtype=torch.int64,
        ).to(torch.int32)
        self.state = MDState(positions=x0, velocities=v0, seeds=seeds, step=0)
        self.replica_ids = torch.arange(
            self.n_replicas, dtype=torch.int32, device=self.device
        )
        self._swap_gen = gen

    # --- phases -----------------------------------------------------------------

    def _md_chunk(self, state: MDState, temps: torch.Tensor, n_steps: int):
        """All replicas ``n_steps`` at per-replica temperatures; returns
        the new state and the energies at its positions (Metropolis needs
        the potential at the post-chunk configurations)."""
        args = (state.positions, state.velocities, state.seeds, temps,
                n_steps, state.step)
        if self.use_kernel:
            x, v, energies = self._chunk(*args)
        else:
            x, v, energies = self._chunk.reference(*args)
        return dataclasses.replace(
            state, positions=x, velocities=v, step=state.step + n_steps
        ), energies

    def _attempt_swaps(
        self,
        state: MDState,
        energies: torch.Tensor,
        replica_ids: torch.Tensor,
        parity: int,
        u: torch.Tensor,
    ):
        """Parity-alternating neighbour Metropolis swap.

        For rung pair (r, r+1) with matching parity: accept with probability
        min(1, exp[(beta_r - beta_{r+1})(E_r - E_{r+1})]) using the left
        rung's uniform ``u[r]``, and exchange the configurations (positions,
        velocities, seeds, identities), rescaling velocities by
        sqrt(T_self / T_source). Returns ``(state, ids, acc_left)`` with
        ``acc_left (R,)`` = 1/0 on attempted left rungs, NaN elsewhere."""
        R = self.n_replicas
        dev = energies.device
        betas = 1.0 / (BOLTZMANN_CONSTANT_KJ_PER_MOL * self.ladder)
        r = torch.arange(R, device=dev)
        is_left = (r % 2) == (int(parity) % 2)
        partner = torch.clamp(torch.where(is_left, r + 1, r - 1), 0, R - 1)
        paired = (partner != r) & torch.where(is_left, partner > r, partner < r)
        log_acc = (betas - betas[partner]) * (energies - energies[partner])
        pair_lo = torch.minimum(r, partner)
        accept = (torch.log(u[pair_lo] + 1e-30) < log_acc) & paired
        target = torch.where(accept, partner, r)
        scale = torch.sqrt(self.ladder / self.ladder[target])
        new_state = dataclasses.replace(
            state,
            positions=state.positions[target],
            velocities=state.velocities[target] * scale[:, None, None],
            seeds=state.seeds[target],
        )
        acc_left = torch.where(
            is_left & paired, accept.to(torch.float32),
            torch.full((R,), float("nan"), device=dev),
        )
        return new_state, replica_ids[target], acc_left

    def run(self, n_steps: int) -> RemdResult:
        """Heating, equilibration, then ``n_steps // exchange_frequency``
        exchange windows; frames every ``report_interval`` steps."""
        cfg = self.config
        if n_steps % cfg.exchange_frequency != 0:
            raise ValueError(
                f"n_steps {n_steps} must be a multiple of exchange_frequency "
                f"{cfg.exchange_frequency}"
            )
        state = self.state
        if cfg.heating_steps > 0:
            n_ramp = 10
            per = max(cfg.heating_steps // n_ramp, 1)
            for i in range(n_ramp):
                frac = (i + 1) / n_ramp
                temps = cfg.t_min + frac * (self.ladder - cfg.t_min)
                state, _ = self._md_chunk(state, temps, per)
        if cfg.equilibration_steps > 0:
            state, _ = self._md_chunk(state, self.ladder, cfg.equilibration_steps)

        R, N = self.n_replicas, self.system.n_atoms
        n_attempts = n_steps // cfg.exchange_frequency
        fpc = max(cfg.exchange_frequency // cfg.report_interval, 1)
        F = n_attempts * fpc
        dev = self.device
        i16 = cfg.frame_precision == "i16"
        frames = torch.empty(
            (F, R, N, 3), dtype=torch.int16 if i16 else torch.float32, device=dev
        )
        frame_e = torch.empty((F, R), dtype=torch.float32, device=dev)
        ids_hist = torch.empty((n_attempts + 1, R), dtype=torch.int32, device=dev)
        acc_hist = torch.empty((n_attempts, R), dtype=torch.float32, device=dev)
        replica_ids = self.replica_ids
        ids_hist[0] = replica_ids
        f = 0
        for a in range(n_attempts):
            for _ in range(fpc):
                state, energies = self._md_chunk(state, self.ladder, cfg.report_interval)
                if i16:
                    # XTC-style fixed point at 1e-3 nm; out-of-range values
                    # poison to INT16_MIN (-32.768 nm) instead of wrapping
                    q = torch.round(state.positions * 1000.0)
                    frames[f] = torch.where(
                        torch.abs(q) > 32767.0, torch.full_like(q, -32768.0), q
                    ).to(torch.int16)
                else:
                    frames[f] = state.positions
                frame_e[f] = energies
                f += 1
            u = torch.rand(R, generator=self._swap_gen, device=dev)
            state, replica_ids, acc = self._attempt_swaps(
                state, energies, replica_ids, a, u
            )
            ids_hist[a + 1] = replica_ids
            acc_hist[a] = acc
        self.state = state
        self.replica_ids = replica_ids

        pos = frames.cpu().numpy()
        if i16:
            pos = pos.astype(np.float32) / 1000.0
        acc = acc_hist.cpu().numpy()
        pair_acc = np.full(R - 1, np.nan)
        for p in range(R - 1):
            vals = acc[:, p]
            vals = vals[np.isfinite(vals)]
            if vals.size:
                pair_acc[p] = float(vals.mean())
        return RemdResult(
            positions=pos,
            potential_energy=frame_e.cpu().numpy(),
            temperatures=self.ladder.cpu().numpy(),
            replica_ids=ids_hist.cpu().numpy(),
            acceptance_matrix=pair_acc,
            exchange_attempts=n_attempts,
            n_steps=n_steps,
            dt_ps=cfg.dt_ps,
            frames_per_attempt=fpc,
        )


def run_replica_exchange(
    pdb_file,
    *,
    n_steps: int = 10_000,
    config: Optional[RemdConfig] = None,
    device="cpu",
    use_kernel: bool = False,
    implicit_solvent: bool = True,
    gb_model: str = "gbn2",
    bias_fn=None,
    mesh=None,
    target_acceptance: Optional[float] = None,
    constraints: Optional[str] = None,
) -> Tuple[RemdResult, System]:
    """One-call REMD on the implicit-solvent dense path.

    Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
    item: ``bias_fn`` (A9), ``mesh`` (A13), ``target_acceptance`` and
    ``constraints`` (A11), and solvated inputs with a periodic box (A12)."""
    from ..io.pdb import read_pdb
    from ..md.forcefield import build_system

    if bias_fn is not None:
        raise NotImplementedError("bias_fn: bias potentials are ROADMAP queue A9")
    if mesh is not None:
        raise NotImplementedError("mesh: multi-device REMD is ROADMAP queue A13")
    if target_acceptance is not None:
        raise NotImplementedError(
            "target_acceptance: remd/ladder.py is ROADMAP queue A11"
        )
    if constraints not in (None, "none"):
        raise NotImplementedError("constraints: SHAKE/RATTLE is ROADMAP queue A11")
    structure = read_pdb(pdb_file) if not hasattr(pdb_file, "residues") else pdb_file
    if getattr(structure, "box", None) is not None:
        raise NotImplementedError(
            "solvated input with a periodic box: explicit solvent is ROADMAP "
            "queue A12"
        )
    system, positions = build_system(
        structure, implicit_solvent=implicit_solvent, gb_model=gb_model,
        device=device,
    )
    remd = ReplicaExchange(
        system, positions, config or RemdConfig(), device=device,
        use_kernel=use_kernel,
    )
    return remd.run(n_steps), system


__all__ = ["RemdConfig", "RemdResult", "ReplicaExchange", "run_replica_exchange"]
