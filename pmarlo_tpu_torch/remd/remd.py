"""Replica-exchange MD with replicas as the leading tensor dimension.

Port of ``pmarlo_tpu/remd/remd.py`` (implicit and explicit solvent).
State is rung-major: slot r always holds the configuration simulating at
``ladder[r]``, so per-rung trajectories are demuxed by construction, and the
replica-identity permutation is recorded for per-walker views. Exchanges
are parity-alternating neighbour Metropolis swaps with velocity rescaling
by sqrt(T_new / T_old).

Two MD paths run the exchange windows of ``run()``:

- the fused chunk (``md/fused_md.py``), unconstrained and up to 512 atoms:
  with ``use_kernel=True`` on a CUDA device one launch of the fused CUDA
  kernel per window, otherwise its plain PyTorch twin; ``kernel_bias``
  puts a DeepTICA CV bias into that kernel;
- a ``force_fn`` (for protein scale ``md.pair_force.build_pair_force_fn``,
  for explicit solvent ``md.periodic_force`` or ``md.cell_force``, whose
  CUDA kernels run on CUDA tensors) under batched ``langevin_step``,
  optionally with SHAKE/RATTLE ``constraints`` and with a Python
  ``bias_fn`` composed in. The cell-list sweep's replica-batched stateful
  entries (``init_state_batched`` / ``apply_batched``) carry its cell
  assignment through a window.

``mesh=`` (a 1-D ``DeviceMesh``, ``parallel.replica_mesh``) shards the
rungs: rank r holds rungs ``[r R / n, (r + 1) R / n)`` on its device and
runs them through its force path (the plain dense step, or the given
``force_fn``: the pair, periodic or cell sweeps); each window's noise stays
keyed by the global rung index. At an exchange attempt one ``all_reduce``
gathers the R energies and each rank's first and last rung; every rank
takes the same decisions from ``swap_uniforms``, and the configurations
that cross a block boundary come from that buffer. Frames, energies and
kinetic temperatures are gathered at the end of ``run()``, so every rank
returns the ``RemdResult`` of the serial run.

``run_fused()`` runs the whole of the fused-chunk path (MD, frames, swaps,
identities) in ONE kernel launch. Swap uniforms are a pure function of
``(config.seed, attempt, pair)`` (``swap_uniforms``, Philox), drawn the
same way by ``run()``, ``run_fused()`` and the kernel, so the paths make
the same decisions from the same energies.

Frames go into an ``(F, R, N, 3)`` buffer preallocated on the device and
are copied to the host once per call.

With the recorder of ``utils/profiling.py`` on, set-up and ``run_fused``
record spans (set-up: ``remd.init`` with ``kernels.load``, ``remd.plan``,
``remd.minimize``, ``remd.state``; a call: ``remd.run_fused``, a segment of
its own, with ``remd.prepare`` (``remd.launch`` or, on the CPU,
``remd.reference``) and ``remd.finish`` (``remd.to_host``, ``remd.result``,
``remd.stamps``)), the counters ``remd.host_syncs`` / ``remd.host_bytes``
of the blocking device-to-host copies, and the fused kernel's step-phase
cycles (``md_step.cycles.<phase>``, ``md_step.sampled_steps``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import default_device
from ..constants import (
    BOLTZMANN_CONSTANT_KJ_PER_MOL,
    DEFAULT_FRICTION_PER_PS,
    DEFAULT_TIMESTEP_PS,
    REMD_DEFAULT_EXCHANGE_FREQUENCY,
)
from .. import _kernels
from ..md.fused_md import STAMP_PHASES, FusedRemdOutput, build_fused_chunk, step_phase_cycles
from ..md.integrate import (
    MDState,
    _uniform24,
    initialize_velocities,
    instantaneous_temperature,
    kinetic_energy,
    langevin_step,
    make_force_fn,
    philox4x32_10,
    remove_com_motion,
    stateful_entries,
)
from ..md.minimize import minimize_energy
from ..md.setup import compose_bias
from ..md.system import System
from ..utils import profiling
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
    #: (F, R) kinetic temperature of the state velocities at each frame,
    #: degrees of freedom less the constraints
    kinetic_temperature: Optional[np.ndarray] = None
    #: host seconds of the run() call (it ends in copies to the host, so
    #: the device work is inside)
    wall_seconds: float = 0.0

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


#: second Philox key word of the swap stream (``kSwapKey`` in
#: ``csrc/fused_md.cu``); the MD noise streams hold the replica index there
SWAP_KEY = 0x53574150


def swap_uniforms(seed: int, attempt: int, n_replicas: int, device) -> torch.Tensor:
    """The Metropolis uniforms of exchange attempt ``attempt``: ``u[p]`` in
    (0, 1) decides neighbour pair ``(p, p + 1)``. Philox4x32-10 with key
    ``(seed, SWAP_KEY)`` and counter ``(attempt low word, attempt high word,
    p, 1)``; the fused REMD kernel computes the same numbers."""
    pairs = torch.arange(n_replicas, dtype=torch.int64, device=device)
    full = lambda v: torch.full_like(pairs, int(v))  # noqa: E731
    w0, _, _, _ = philox4x32_10(
        full(attempt & 0xFFFFFFFF), full((attempt >> 32) & 0xFFFFFFFF), pairs, full(1),
        full(int(seed) & 0x7FFFFFFF), full(SWAP_KEY),
    )
    return _uniform24(w0)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as host numpy; a blocking copy from a device is counted
    (``remd.host_syncs``, ``remd.host_bytes``) while the recorder is on."""
    if t.device.type != "cpu":
        profiling.count("remd.host_syncs", 1)
        profiling.count("remd.host_bytes", t.numel() * t.element_size())
    return t.cpu().numpy()


def _quantize_i16(x: torch.Tensor) -> torch.Tensor:
    """XTC-style fixed point at 1e-3 nm; out-of-range and non-finite values
    poison to INT16_MIN (-32.768 nm) instead of wrapping or casting NaN."""
    q = torch.round(x * 1000.0)
    bad = ~torch.isfinite(q) | (torch.abs(q) > 32767.0)
    return torch.where(bad, torch.full_like(q, -32768.0), q).to(torch.int16)


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
        device=None,
        use_kernel: bool = False,
        minimize: bool = True,
        force_fn=None,
        constraints=None,
        minimize_force_fn=None,
        bias_fn=None,
        kernel_bias=None,
        mesh=None,
    ):
        """``device`` defaults to the system's (with ``mesh``: this rank's,
        ``parallel.mesh.rank_device``). ``use_kernel=True`` runs
        every window through the fused CUDA kernel, which needs ``device``
        to be a CUDA device; ``False`` runs the plain PyTorch twin on
        ``device``.

        ``kernel_bias`` runs a DeepTICA harmonic-expansion CV bias INSIDE
        the fused kernel (JAX's ``pallas_bias``): ``{"model":
        DeepTICAModel (tanh MLP on cos/sin dihedral features), "quads":
        (M, 4) dihedral atom indices, "strength": float}``. An arbitrary
        Python ``bias_fn(positions) -> energy`` runs on the plain path,
        with forces by autograd, and is also applied to the minimization.

        ``force_fn`` (``x (R, N, 3) -> (energies (R,), forces)``, e.g.
        ``md.pair_force.build_pair_force_fn(system)``) replaces the fused
        chunk: windows are batched ``langevin_step`` calls and the swap
        energies come from ``force_fn`` at the post-window positions.
        ``constraints`` (``md.constraints.build_h_constraints``) adds
        SHAKE/RATTLE to every replica's step; the fused chunk does not
        constrain, so it refuses them (as the JAX fused chunk does).
        ``minimize_force_fn`` minimizes through the given forces (the
        full system's, stiff X-H bonds kept) instead of autograd.

        ``mesh`` shards the rungs over the ranks (module docstring); the
        ladder must divide over it, and the fused kernel is single-chip."""
        with profiling.span("remd.init"):
            self.mesh = mesh
            if mesh is not None:
                from ..parallel.mesh import check_mesh, rank_device

                check_mesh(mesh)
                if use_kernel:
                    raise ValueError("use_kernel=True is single-chip only for now")
                if getattr(force_fn, "slab", None) is not None:
                    # its all_reduce would add one rank's rungs to another's
                    raise ValueError(
                        "a force_fn split into x-slabs over a mesh cannot run under a "
                        "replica mesh: the ranks hold different rungs")
                if device is None:
                    device = rank_device(mesh)
            self.device = torch.device(device) if device is not None else system.device
            # recorded in checkpoints, so that a resume supplies the same force path
            self._force_fn_is_override = force_fn is not None
            if constraints is not None and use_kernel:
                raise ValueError(
                    "constraints are integrated by langevin_step; the fused "
                    "chunk does not SHAKE (use use_kernel=False)"
                )
            if force_fn is not None and use_kernel:
                raise ValueError("force_fn override and use_kernel are exclusive")
            if use_kernel and bias_fn is not None:
                raise ValueError(
                    "use_kernel=True takes the structured kernel_bias (in-kernel "
                    "DeepTICA bias), not an arbitrary bias_fn; use the plain "
                    "path for python bias functions"
                )
            if kernel_bias is not None and not use_kernel:
                raise ValueError("kernel_bias requires use_kernel=True")
            if use_kernel and self.device.type != "cuda":
                raise ValueError(
                    f"use_kernel=True needs a CUDA device, got {self.device}"
                )
            self.system = system.to(self.device)
            self.bias_fn = bias_fn
            # run_fused() reads this to wire the in-kernel CV bias: it is the
            # same chunk, so a biased run_fused cannot come out unbiased
            self._kernel_bias = kernel_bias
            self.config = config
            self.use_kernel = use_kernel
            self.ladder = torch.as_tensor(
                config.ladder(), dtype=torch.float32, device=self.device
            )
            self.n_replicas = int(self.ladder.shape[0])
            #: this rank's rungs [lo, hi) (all of them without a mesh)
            self._block = (0, self.n_replicas)
            if mesh is not None:
                from ..parallel.mesh import mesh_block

                self._block = mesh_block(self.n_replicas, mesh, "the replica ladder")
            lo, hi = self._block
            self._local_ladder = self.ladder[lo:hi]
            if constraints is not None:
                constraints = constraints.to(self.device)
            self._constraints = constraints
            if force_fn is None and constraints is not None:
                force_fn = make_force_fn(self.system)
            if bias_fn is not None:
                # compose the bias into an override: storing the override alone
                # would run unbiased dynamics while the caller believes the
                # bias is active
                force_fn = (make_force_fn(self.system, bias_fn) if force_fn is None
                            else compose_bias(force_fn, bias_fn))
            self._force_fn = force_fn
            self._chunk = None
            if force_fn is None and use_kernel:
                with profiling.span("kernels.load") as sp:
                    before = _kernels.loaded()
                    _kernels.library()
                    if sp is not None:
                        sp.attrs["library"] = ("loaded before" if before
                                               else "nvcc" if _kernels.compiled else "cache")
            with profiling.span("remd.plan"):
                if force_fn is None:
                    bias_kwargs = {}
                    if kernel_bias is not None:
                        bias_kwargs = dict(
                            bias_model=kernel_bias["model"], bias_quads=kernel_bias["quads"],
                            bias_strength=kernel_bias.get("strength", 1.0),
                        )
                    self._chunk = build_fused_chunk(
                        self.system, dt=config.dt_ps, friction=config.friction_per_ps,
                        n_replicas=hi - lo, **bias_kwargs,
                    )
                    if use_kernel:
                        # the launch shape now, not at the first launch
                        self._chunk.plan_remd(hi - lo)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(config.seed))
            x = positions.to(device=self.device, dtype=torch.float32)
            if minimize:
                with profiling.span("remd.minimize"):
                    x, _ = minimize_energy(self.system, x, force_fn=minimize_force_fn,
                                           bias_fn=bias_fn)
                    if profiling.RECORDER.on and x.device.type == "cuda":
                        # the span holds FIRE's device work, not only its dispatch
                        torch.cuda.synchronize(x.device)
            with profiling.span("remd.state"):
                self._initial_state(x, gen)

    def _initial_state(self, x: torch.Tensor, gen: torch.Generator) -> None:
        """Every rung from structure ``x``, velocities and Philox seeds from
        ``gen``; no exchange attempted yet."""
        mesh = self.mesh
        if mesh is not None:
            from ..parallel.mesh import broadcast_first

            # every rank starts from the first rank's structure: forces that
            # add with atomics (the cell path's band correction, the Newton
            # sums) can leave the ranks' minimizations apart in the last bits
            x = broadcast_first(x.contiguous(), mesh)
        x0 = x[None].expand((self.n_replicas,) + tuple(x.shape)).contiguous()
        v0 = remove_com_motion(
            self.system, initialize_velocities(self.system, gen, self.ladder)
        )
        seeds = torch.randint(
            0, 2**31 - 1, (self.n_replicas,), generator=gen,
            device=self.device, dtype=torch.int64,
        ).to(torch.int32)
        self.state = self._local(MDState(positions=x0, velocities=v0, seeds=seeds, step=0))
        self.replica_ids = torch.arange(
            self.n_replicas, dtype=torch.int32, device=self.device
        )
        #: exchange attempts made so far: the counter of the swap stream
        self._attempts_done = 0

    # --- the rank's block -------------------------------------------------------

    def _local(self, state: MDState) -> MDState:
        """This rank's rungs of a state of all R."""
        lo, hi = self._block
        return dataclasses.replace(state, positions=state.positions[lo:hi].contiguous(),
                                   velocities=state.velocities[lo:hi].contiguous(),
                                   seeds=state.seeds[lo:hi].contiguous())

    def global_state(self) -> MDState:
        """The state of all R rungs (gathered from every rank with a mesh:
        a collective, so every rank calls it)."""
        if self.mesh is None:
            return self.state
        from ..parallel.mesh import gather_blocks

        s = self.state
        return dataclasses.replace(
            s, positions=gather_blocks(s.positions, self.mesh),
            velocities=gather_blocks(s.velocities, self.mesh),
            seeds=gather_blocks(s.seeds, self.mesh))

    def set_global_state(self, state: MDState) -> None:
        """Install a state of all R rungs; this rank keeps its block."""
        self.state = self._local(state)

    def _exchange_inputs(self, state: MDState, energies: torch.Tensor):
        """Every rung's energy ``(R,)`` and the window of rows a swap can
        reach: this rank's rungs with the previous rank's last and the next
        rank's first rung around them, each row (positions, velocities,
        seed) flattened in float64 (which holds each exactly), from one
        ``all_reduce``."""
        from ..parallel.mesh import gather_blocks

        n_local = state.positions.shape[0]
        rows = torch.cat([state.positions.flatten(1).double(),
                          state.velocities.flatten(1).double(),
                          state.seeds[:, None].double()], 1)
        local = torch.cat([energies.double(), rows[[0, -1]].flatten()])
        g = gather_blocks(local, self.mesh).reshape(self.mesh.size(), -1)
        edges = g[:, n_local:].reshape(2 * self.mesh.size(), -1)
        r = self.mesh.get_local_rank()
        before = edges[2 * r - 1] if r > 0 else rows[0]
        after = edges[2 * r + 2] if r < self.mesh.size() - 1 else rows[-1]
        window = torch.cat([before[None], rows, after[None]])
        return g[:, :n_local].reshape(-1).to(energies.dtype), window

    # --- phases -----------------------------------------------------------------

    def _md_chunk(self, state: MDState, temps: torch.Tensor, n_steps: int):
        """All replicas ``n_steps`` at per-replica temperatures; returns
        the new state and the energies at its positions (Metropolis needs
        the potential at the post-chunk configurations)."""
        if self._force_fn is not None:
            cfg = self.config
            # the cell-list sweep threads its cell assignment through the steps
            init_state, apply = stateful_entries(self._force_fn, state.positions)
            fstate = None if init_state is None else init_state(state.positions)
            for _ in range(n_steps):
                out = langevin_step(
                    self.system, state, dt=cfg.dt_ps,
                    friction=cfg.friction_per_ps, temperature_K=temps,
                    force_fn=self._force_fn if apply is None else apply,
                    constraints=self._constraints, force_state=fstate,
                    replica_offset=self._block[0],
                )
                state = out[0]
                if fstate is not None:
                    fstate = out[2]
            if fstate is not None:
                return state, apply(state.positions, fstate)[0]
            return state, self._force_fn(state.positions)[0]
        args = (state.positions, state.velocities, state.seeds, temps,
                n_steps, state.step)
        if self.use_kernel:
            x, v, energies = self._chunk(*args)
        else:
            x, v, energies = self._chunk.reference(*args, replica_offset=self._block[0])
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
        ``acc_left (R,)`` = 1/0 on attempted left rungs, NaN elsewhere.
        With a mesh ``state`` and ``energies`` are this rank's rungs, and
        every rank takes the same decisions on the gathered energies."""
        R = self.n_replicas
        dev = energies.device
        if self.mesh is not None:
            energies, window = self._exchange_inputs(state, energies)
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
        if self.mesh is None:
            new_state = dataclasses.replace(
                state,
                positions=state.positions[target],
                velocities=state.velocities[target] * scale[:, None, None],
                seeds=state.seeds[target],
            )
        else:
            lo, hi = self._block
            rows = window[target[lo:hi] - lo + 1]
            shape = (hi - lo,) + tuple(state.positions.shape[1:])
            k = state.positions[0].numel()
            new_state = dataclasses.replace(
                state,
                positions=rows[:, :k].to(torch.float32).reshape(shape),
                velocities=rows[:, k:2 * k].to(torch.float32).reshape(shape)
                * scale[lo:hi, None, None],
                seeds=rows[:, 2 * k].to(torch.int32),
            )
        acc_left = torch.where(
            is_left & paired, accept.to(torch.float32),
            torch.full((R,), float("nan"), device=dev),
        )
        return new_state, replica_ids[target], acc_left

    def run(self, n_steps: int) -> RemdResult:
        """Heating, equilibration, then ``n_steps // exchange_frequency``
        exchange windows; frames every ``report_interval`` steps."""
        t_start = time.perf_counter()
        cfg = self.config
        if n_steps % cfg.exchange_frequency != 0:
            raise ValueError(
                f"n_steps {n_steps} must be a multiple of exchange_frequency "
                f"{cfg.exchange_frequency}"
            )
        state = self.state
        ladder = self._local_ladder
        if cfg.heating_steps > 0:
            n_ramp = 10
            per = max(cfg.heating_steps // n_ramp, 1)
            for i in range(n_ramp):
                frac = (i + 1) / n_ramp
                temps = cfg.t_min + frac * (ladder - cfg.t_min)
                state, _ = self._md_chunk(state, temps, per)
        if cfg.equilibration_steps > 0:
            state, _ = self._md_chunk(state, ladder, cfg.equilibration_steps)

        R, N = self.n_replicas, self.system.n_atoms
        Rl = self._block[1] - self._block[0]
        n_attempts = n_steps // cfg.exchange_frequency
        fpc = max(cfg.exchange_frequency // cfg.report_interval, 1)
        F = n_attempts * fpc
        dev = self.device
        i16 = cfg.frame_precision == "i16"
        frames = torch.empty(
            (F, Rl, N, 3), dtype=torch.int16 if i16 else torch.float32, device=dev
        )
        frame_e = torch.empty((F, Rl), dtype=torch.float32, device=dev)
        frame_t = torch.empty((F, Rl), dtype=torch.float32, device=dev)
        n_con = 0 if self._constraints is None else self._constraints.n_constraints
        ids_hist = torch.empty((n_attempts + 1, R), dtype=torch.int32, device=dev)
        acc_hist = torch.empty((n_attempts, R), dtype=torch.float32, device=dev)
        replica_ids = self.replica_ids
        ids_hist[0] = replica_ids
        f = 0
        for a in range(n_attempts):
            for _ in range(fpc):
                state, energies = self._md_chunk(state, ladder, cfg.report_interval)
                frames[f] = _quantize_i16(state.positions) if i16 else state.positions
                frame_e[f] = energies
                frame_t[f] = instantaneous_temperature(
                    self.system, state.velocities, n_con)
                f += 1
            u = swap_uniforms(cfg.seed, self._attempts_done + a, R, dev)
            state, replica_ids, acc = self._attempt_swaps(
                state, energies, replica_ids, a, u
            )
            ids_hist[a + 1] = replica_ids
            acc_hist[a] = acc
        self.state = state
        self.replica_ids = replica_ids
        self._attempts_done += n_attempts
        if self.mesh is not None:
            from ..parallel.mesh import gather_blocks

            frames, frame_e, frame_t = (gather_blocks(t, self.mesh, dim=1)
                                        for t in (frames, frame_e, frame_t))

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
            kinetic_temperature=frame_t.cpu().numpy(),
            wall_seconds=time.perf_counter() - t_start,
        )


    def run_fused(self, n_steps: int) -> RemdResult:
        """Fully-fused REMD: the ENTIRE run (MD, frame capture, parity
        Metropolis swaps, identity bookkeeping) is one kernel launch
        (``md/fused_md.py FusedChunk.remd``; ``build_pallas_remd`` in JAX).
        Unbiased or in-kernel-bias configurations of the fused-chunk path;
        as in JAX it runs the exchange windows only (no heating or
        equilibration phase). On a CUDA device the kernel is launched
        whatever ``use_kernel`` says (as JAX's ``run_fused`` always builds
        ``build_pallas_remd``) or the call raises; the plain version
        (``_run_fused_reference``: a loop of the chunk's twin and
        ``_attempt_swaps`` over the same swap uniforms) runs only when the
        replicas lie on the CPU. With the recorder on the call is a
        segment of spans (module docstring) and the kernel the stamped
        build, which computes the same bits."""
        with profiling.span("remd.run_fused", segment=True, n_steps=int(n_steps)):
            t_start = time.perf_counter()
            with profiling.span("remd.prepare"):
                out, A, fpc = self._fused_launch(n_steps)
            with profiling.span("remd.finish"):
                return self._fused_result(out, n_steps, A, fpc, t_start)

    def _fused_launch(self, n_steps: int) -> Tuple[FusedRemdOutput, int, int]:
        """``run_fused``'s checks and its one launch (or, on the CPU, the
        plain version) from the present state."""
        if self.mesh is not None:
            raise ValueError("run_fused is single-chip; use run() with a mesh")
        if self.bias_fn is not None:
            raise ValueError("run_fused supports in-kernel bias only (kernel_bias)")
        if self._chunk is None:
            raise ValueError(
                "run_fused runs the fused chunk; a force_fn override or "
                "constraints go through run()"
            )
        cfg = self.config
        if n_steps < cfg.exchange_frequency or n_steps % cfg.exchange_frequency != 0:
            raise ValueError(
                f"n_steps {n_steps} must be a positive multiple of "
                f"exchange_frequency {cfg.exchange_frequency}"
            )
        A = n_steps // cfg.exchange_frequency
        fpc = max(cfg.exchange_frequency // cfg.report_interval, 1)
        state = self.state
        if self.device.type == "cuda":
            out = self._chunk.remd(
                state.positions, state.velocities, state.seeds, self.replica_ids,
                self.ladder, n_attempts=A, frames_per_attempt=fpc,
                report_interval=cfg.report_interval, step_offset=state.step,
                swap_seed=cfg.seed, attempt_offset=self._attempts_done,
                stamps=profiling.RECORDER.on,
            )
        else:
            with profiling.span("remd.reference"):
                out = self._run_fused_reference(A, fpc)
        return out, A, fpc

    def _fused_result(self, out: FusedRemdOutput, n_steps: int, A: int, fpc: int,
                      t_start: float) -> RemdResult:
        """The state and the swap counter moved past the launch, its outputs
        to the host (six blocking copies) and its ``RemdResult``; the
        step-phase stamps to counters where there are any."""
        self.state = MDState(positions=out.positions, velocities=out.velocities,
                             seeds=out.seeds, step=self.state.step + n_steps)
        self.replica_ids = out.ids_hist[-1]
        self._attempts_done += A
        cfg = self.config
        R = self.n_replicas
        n_dof = 3 * self.system.n_atoms
        with profiling.span("remd.to_host"):
            frames = out.frames
            if cfg.frame_precision == "i16":
                frames = _quantize_i16(frames)
            pos = _to_host(frames)
            acc = _to_host(out.accept)
            energy = _to_host(out.frame_energy)
            temps = _to_host(self.ladder)
            ids = _to_host(out.ids_hist)
            kin = _to_host(2.0 * out.frame_kinetic / (n_dof * BOLTZMANN_CONSTANT_KJ_PER_MOL))
        with profiling.span("remd.result"):
            if cfg.frame_precision == "i16":
                pos = pos.astype(np.float32) / 1000.0
            pair_acc = np.full(R - 1, np.nan)
            for pair in range(R - 1):
                # pair (p, p+1) is attempted on parities where p is "left"
                attempts = acc[pair % 2::2, pair]
                if attempts.size:
                    pair_acc[pair] = float(attempts.mean())
            result = RemdResult(
                positions=pos,
                potential_energy=energy,
                temperatures=temps,
                replica_ids=ids,
                acceptance_matrix=pair_acc,
                exchange_attempts=A,
                n_steps=n_steps,
                dt_ps=cfg.dt_ps,
                frames_per_attempt=fpc,
                kinetic_temperature=kin,
                wall_seconds=time.perf_counter() - t_start,
            )
        if out.stamps is not None:
            with profiling.span("remd.stamps"):
                # summed on the device; read when the counters are
                cycles = step_phase_cycles(out.stamps)
                for k, phase in enumerate(STAMP_PHASES):
                    profiling.count(f"md_step.cycles.{phase}", cycles[k])
                profiling.count("md_step.sampled_steps",
                                out.stamps.shape[0] * out.stamps.shape[1])
        return result

    def _run_fused_reference(self, n_attempts: int, fpc: int) -> FusedRemdOutput:
        """Plain PyTorch version of ``FusedChunk.remd``, from the present
        state; it reads the state and the swap counter and changes
        neither."""
        cfg = self.config
        R = self.n_replicas
        state, ids = self.state, self.replica_ids
        frames, frame_e, frame_ke, ids_hist, accept = [], [], [], [ids], []
        for a in range(n_attempts):
            for _ in range(fpc):
                x, v, energies = self._chunk.reference(
                    state.positions, state.velocities, state.seeds, self.ladder,
                    cfg.report_interval, state.step)
                state = dataclasses.replace(
                    state, positions=x, velocities=v,
                    step=state.step + cfg.report_interval)
                frames.append(x)
                frame_e.append(energies)
                frame_ke.append(kinetic_energy(self.system, v))
            u = swap_uniforms(cfg.seed, self._attempts_done + a, R, self.device)
            state, ids, acc_left = self._attempt_swaps(state, energies, ids, a, u)
            left = torch.nan_to_num(acc_left, nan=0.0)
            accept.append(left + torch.roll(left, 1))   # both rungs of a pair
            ids_hist.append(ids)
        return FusedRemdOutput(
            positions=state.positions, velocities=state.velocities, seeds=state.seeds,
            frames=torch.stack(frames), frame_energy=torch.stack(frame_e),
            frame_kinetic=torch.stack(frame_ke), ids_hist=torch.stack(ids_hist),
            accept=torch.stack(accept),
        )


def run_replica_exchange(
    pdb_file,
    *,
    n_steps: int = 10_000,
    config: Optional[RemdConfig] = None,
    device=None,
    use_kernel: bool = False,
    implicit_solvent: bool = True,
    gb_model: str = "gbn2",
    bias_fn=None,
    mesh=None,
    target_acceptance: Optional[float] = None,
    cutoff: float = 0.9,
    switch_distance: Optional[float] = None,
    nonbonded: str = "auto",
    constraints: Optional[str] = None,
) -> Tuple[RemdResult, System]:
    """One-call REMD on ``device`` (``None``: the card when there is one,
    ``_device.default_device()``).

    **Implicit solvent.** The system, constraints and force path come from
    ``md.setup.build_implicit_setup`` (the same recipe for every entry
    point): past 600 atoms on a CUDA device the pair kernels
    (``md/pair_force.py``) run every force evaluation, minimization
    included; below it the dense path runs, through the fused CUDA chunk
    when ``use_kernel=True``. ``constraints="hbonds"`` SHAKE/RATTLEs every
    X-H bond (OpenMM HBonds), which with HMR allows 4 fs steps; the fused
    chunk refuses constraints.

    **Explicit solvent.** A solvated input (CRYST1 box + waters) switches
    to explicit-solvent REMD (``md.setup.build_explicit_setup``): the
    periodic LJ + Coulomb potential at ``cutoff``, rigid TIP3P and
    X-H constraints in every replica, constrained bonded terms stripped
    from the MD force path, and the ``nonbonded`` engine ("dense": the
    O(N^2) minimum-image sweep, "cells": the O(N) cell-list sweep, both
    with reaction field; "pme": the cell-list sweep with smooth PME;
    "auto": cells from 3,000 atoms up). The structure is minimized through the
    FULL system's sweep; ladder probes and Metropolis energies run through
    the MD sweep. ``switch_distance`` enables the LJ switching function.
    The explicit path always constrains: ``constraints="none"`` raises.
    ``use_kernel`` (the fused chunk) has no part in it.

    ``target_acceptance`` replaces the config's geometric ladder with one
    designed from short energy-fluctuation probes between its end
    temperatures (``remd/ladder.py``). ``bias_fn`` (positions -> energy)
    biases every replica's forces on the plain path (and the implicit
    path's minimization); with ``use_kernel=True`` it raises (the kernel
    takes ``ReplicaExchange(kernel_bias=...)``).

    ``nonbonded="pme"`` runs the cell-list sweep with smooth PME.
    ``mesh`` (``parallel.replica_mesh``) shards the rungs over the ranks
    (``ReplicaExchange``); every rank calls this and gets the same result.
    A ladder designed for ``target_acceptance`` must divide over it."""
    import dataclasses as _dc

    from ..io.pdb import read_pdb
    from ..md.setup import build_explicit_setup, build_implicit_setup, is_explicit_solvent

    if constraints not in (None, "none", "hbonds"):
        raise ValueError(
            f"constraints must be None|'none'|'hbonds', got {constraints!r}"
        )
    config = config or RemdConfig()
    if mesh is not None and device is None:
        from ..parallel.mesh import check_mesh, rank_device

        check_mesh(mesh)
        device = rank_device(mesh)
    device = torch.device(device) if device is not None else default_device()
    structure = read_pdb(pdb_file) if not hasattr(pdb_file, "residues") else pdb_file
    explicit = is_explicit_solvent(structure)
    if explicit:
        if constraints == "none":
            raise ValueError(
                "constraints='none' is not available on the explicit-"
                "solvent path: rigid TIP3P water requires SHAKE"
            )
        setup = build_explicit_setup(
            structure, cutoff=cutoff, switch_distance=switch_distance,
            nonbonded=nonbonded, device=device,
        )
        force_fn, force_path = setup.md_force_fn, setup.nonbonded
        # minimize through the FULL system's sweep (the MD system has the
        # stiff X-H bonds stripped); ReplicaExchange then gets minimize=False
        positions, _ = minimize_energy(setup.system, setup.positions,
                                       force_fn=setup.minimize_force_fn)
    else:
        if switch_distance is not None:
            raise ValueError(
                "switch_distance applies to the explicit-solvent "
                "periodic path only; this structure routed to the "
                "implicit-solvent path (NoCutoff, nothing to switch)"
            )
        setup = build_implicit_setup(
            structure, implicit_solvent=implicit_solvent, gb_model=gb_model,
            constraints=constraints, device=device,
        )
        force_fn, force_path = setup.force_fn, setup.force_path
        positions = setup.positions
    system, cspec = setup.system, setup.constraints
    if target_acceptance is not None:
        from .ladder import suggest_temperature_ladder

        # the probes and the run start from the same relaxed structure
        if not explicit:
            positions, _ = minimize_energy(system, positions,
                                           force_fn=setup.minimize_force_fn)
        ladder = config.ladder()
        designed, _ = suggest_temperature_ladder(
            system, positions, t_min=float(ladder[0]), t_max=float(ladder[-1]),
            target_acceptance=target_acceptance,
            force_fn=force_fn if force_fn is not None else make_force_fn(system),
            constraints=cspec, dt_ps=config.dt_ps,
        )
        if mesh is not None:
            n_dev = mesh.size()
            if len(designed) % n_dev != 0:
                raise ValueError(
                    f"the designed ladder has {len(designed)} rungs, which "
                    f"does not shard over the {n_dev}-device mesh; drop "
                    "the mesh, widen [t_min, t_max], or pass an explicit "
                    "ladder sized for the mesh"
                )
        config = _dc.replace(
            config, temperatures=tuple(float(t) for t in designed),
            n_replicas=len(designed),
        )
    remd = ReplicaExchange(
        system, positions, config, device=device,
        use_kernel=use_kernel and force_path == "dense" and not explicit,
        force_fn=force_fn, constraints=cspec,
        minimize=target_acceptance is None and not explicit,
        minimize_force_fn=setup.minimize_force_fn, bias_fn=bias_fn, mesh=mesh,
    )
    return remd.run(n_steps), system


__all__ = ["RemdConfig", "RemdResult", "ReplicaExchange", "run_replica_exchange",
           "swap_uniforms"]
