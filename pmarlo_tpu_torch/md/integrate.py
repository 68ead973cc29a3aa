"""Folded BAOAB Langevin integration, batched over replicas.

Port of ``pmarlo_tpu/md/integrate.py`` (``langevin_step`` with optional
SHAKE/RATTLE, ``run_md``, ``thermalize``). Positions and velocities are
``(..., N, 3)`` tensors whose leading dimensions are replicas; Python
loops take the place of ``lax.scan``.

Noise: the JAX step splits a PRNG key per step. Here the O-step noise is a
pure function of ``(seed, replica, step, atom)`` through Philox4x32-10 and
Box-Muller (``gaussian_noise``), the same stream the fused CUDA kernel
draws in ``csrc/fused_md.cu``, so the plain loop and the kernel integrate
the same stochastic process. ``MDState.seeds`` carries the per-replica
Philox seed where the JAX state carries its key.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._device import default_device
from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from .system import System
from .vsites import VirtualSites, expanded_energy_and_forces, n_vsites, wrap_force_fn

_MASK32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85


@dataclasses.dataclass(frozen=True)
class MDState:
    """Dynamic state of one simulation or a batch of replicas."""

    positions: torch.Tensor    # (..., N, 3) nm
    velocities: torch.Tensor   # (..., N, 3) nm/ps
    seeds: torch.Tensor        # (...) int32 Philox seed per replica
    step: int = 0              # noise counter: global index of the next step


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * b`` for a 32-bit constant ``a``
    and an int64 tensor ``b`` of 32-bit values, without int64 overflow
    (16-bit halves of ``a``)."""
    x = b * (a & 0xFFFF)            # < 2^48
    y = b * (a >> 16)               # < 2^48
    lo = (x + ((y & 0xFFFF) << 16)) & _MASK32
    hi = (y + (x >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors that hold
    32-bit words. Returns the four output words."""
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform24(w: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a word -> float32 in (0, 1), exact in float32."""
    return ((w >> 8).to(torch.float32) + 0.5) * (1.0 / 16777216.0)


def gaussian_noise(seeds: torch.Tensor, step: int, n_atoms: int,
                   replica_offset: int = 0) -> torch.Tensor:
    """Standard normals ``seeds.shape + (n_atoms, 3)`` for one step.

    Philox key = (seed, replica index), counter = (step low word, step high
    word, atom, 0); the four output words give three normals by
    Box-Muller. The kernel computes the same numbers. A rank that holds
    replicas ``replica_offset, ...`` of a sharded batch keys them by their
    global index."""
    dev = seeds.device
    k0 = (seeds.reshape(-1).to(torch.int64) & _MASK32)[:, None]
    k1 = torch.arange(replica_offset, replica_offset + k0.shape[0], device=dev,
                      dtype=torch.int64)[:, None]
    atoms = torch.arange(n_atoms, device=dev, dtype=torch.int64)[None, :]
    shape = (k0.shape[0], n_atoms)
    c0 = torch.full(shape, step & _MASK32, dtype=torch.int64, device=dev)
    c1 = torch.full(shape, (step >> 32) & _MASK32, dtype=torch.int64, device=dev)
    c2 = atoms.expand(shape)
    c3 = torch.zeros(shape, dtype=torch.int64, device=dev)
    w0, w1, w2, w3 = philox4x32_10(c0, c1, c2, c3, k0, k1)
    two_pi = 2.0 * math.pi
    ra = torch.sqrt(-2.0 * torch.log(_uniform24(w0)))
    rb = torch.sqrt(-2.0 * torch.log(_uniform24(w2)))
    ta = two_pi * _uniform24(w1)
    tb = two_pi * _uniform24(w3)
    z = torch.stack([ra * torch.cos(ta), ra * torch.sin(ta), rb * torch.cos(tb)], -1)
    return z.reshape(tuple(seeds.shape) + (n_atoms, 3))


def _inv_mass(system: System) -> torch.Tensor:
    m = system.masses
    return torch.where(m > 0.0, 1.0 / m, torch.zeros_like(m))[:, None]


def _kT(temperature_K, like: torch.Tensor):
    """kB T broadcastable against ``(..., N, 3)``."""
    t = torch.as_tensor(temperature_K, dtype=like.dtype, device=like.device)
    return BOLTZMANN_CONSTANT_KJ_PER_MOL * t[..., None, None]


def md_state_from_numpy(positions, velocities, step, seed, device=None) -> MDState:
    """The port's state from host arrays: a JAX ``MDState``'s positions,
    velocities and step, with the Philox seed ``seed`` (an int, or one a
    replica) in place of its PRNG key, which a Philox stream cannot take
    over. ``device=None``: ``_device.default_device()``."""
    device = torch.device(device) if device is not None else default_device()
    x = torch.as_tensor(np.asarray(positions, np.float32), device=device)
    seeds = torch.as_tensor(np.broadcast_to(np.asarray(seed, np.int64), x.shape[:-2])
                            .astype(np.int32), device=device)
    return MDState(positions=x,
                   velocities=torch.as_tensor(np.asarray(velocities, np.float32), device=device),
                   seeds=seeds, step=int(np.asarray(step).reshape(-1)[0]))


def initialize_velocities(
    system: System, generator: torch.Generator, temperature_K,
) -> torch.Tensor:
    """Maxwell-Boltzmann velocities (nm/ps). A tensor of temperatures
    ``(R,)`` gives ``(R, N, 3)``, a float gives ``(N, 3)``."""
    ref = system.masses
    kT = _kT(temperature_K, ref)
    sigma = torch.sqrt(kT * _inv_mass(system))
    noise = torch.randn(
        tuple(sigma.shape[:-1]) + (3,), generator=generator, dtype=ref.dtype,
        device=ref.device,
    )
    return sigma * noise


def kinetic_energy(system: System, velocities: torch.Tensor) -> torch.Tensor:
    return 0.5 * (system.masses[:, None] * velocities**2).sum((-2, -1))


def instantaneous_temperature(
    system: System, velocities: torch.Tensor, n_constraints: int = 0,
    remove_com: bool = False,
) -> torch.Tensor:
    """Kinetic temperature ``(...)``. Langevin runs keep the 3 COM dof
    (the O-step re-thermalizes them); NVE runs (friction 0) pass
    ``remove_com=True``, as in the JAX docstring. Massless virtual sites
    carry no degree of freedom."""
    n_dof = max(
        3 * (system.n_atoms - n_vsites(system)) - int(n_constraints)
        - (3 if remove_com else 0), 1
    )
    return 2.0 * kinetic_energy(system, velocities) / (
        n_dof * BOLTZMANN_CONSTANT_KJ_PER_MOL
    )


def remove_com_motion(system: System, velocities: torch.Tensor) -> torch.Tensor:
    """Velocities less the centre-of-mass velocity; massless rows (virtual
    sites) keep theirs, which is 0."""
    m = system.masses[:, None]
    p = (m * velocities).sum(-2, keepdim=True)
    return velocities - p / system.masses.sum() * (m > 0.0)


def bias_energy_and_forces(bias_fn: Callable, x: torch.Tensor):
    """Energy ``(...)`` and forces ``(..., N, 3)`` of a bias
    ``bias_fn(positions (..., N, 3)) -> energy (...)`` by autograd."""
    with torch.enable_grad():
        y = x.detach().requires_grad_(True)
        e = bias_fn(y)
        (g,) = torch.autograd.grad(e.sum(), y)
    return e.detach(), -g


def compose_bias(force_fn: Callable, bias_fn: Callable) -> Callable:
    """Wrap ``force_fn(x) -> (e, f)`` so energies AND forces include the
    CV bias (force = -grad of the bias energy), keeping the cell-list
    force function's stateful entries (``init_state`` / ``apply`` /
    ``init_state_batched`` / ``apply_batched``). Single source for every entry point that combines a force
    function with a bias."""

    def wrapped(x):
        e, f = force_fn(x)
        be, bf = bias_energy_and_forces(bias_fn, x)
        return e + be, f + bf

    def stateful(apply):
        def _apply(x, st):
            e, f, st = apply(x, st)
            be, bf = bias_energy_and_forces(bias_fn, x)
            return e + be, f + bf, st
        return _apply

    if hasattr(force_fn, "init_state"):
        wrapped.init_state = force_fn.init_state
        wrapped.apply = stateful(force_fn.apply)
    if hasattr(force_fn, "init_state_batched"):
        wrapped.init_state_batched = force_fn.init_state_batched
        wrapped.apply_batched = stateful(force_fn.apply_batched)
    return wrapped


def stateful_entries(force_fn: Optional[Callable], positions: torch.Tensor):
    """``(init_state, apply)`` of a stateful force function (the cell-list
    sweep) for positions of this rank, the batched pair for
    ``(R, N, 3)``; ``(None, None)`` for a plain ``force_fn(x)``."""
    names = (("init_state", "apply") if positions.dim() == 2
             else ("init_state_batched", "apply_batched"))
    if force_fn is None or not hasattr(force_fn, names[0]):
        return None, None
    return getattr(force_fn, names[0]), getattr(force_fn, names[1])


def make_force_fn(system: System, bias_fn: Optional[Callable] = None,
                  analytic: bool = True) -> Callable:
    """Build ``force_fn(x) -> (energy, forces)``: with ``analytic`` the
    analytic dense path (``md/analytic.py``, the math the fused kernel
    runs) plus, if given, a bias ``bias_fn(positions) -> energy`` whose
    forces come from autograd; with ``analytic=False`` the energy
    ``forces.potential_energy`` (the bias in it) and its autograd gradient.
    Either is wrapped for the system's virtual sites
    (``vsites.wrap_force_fn``). Leading dimensions of ``x`` batch."""
    if analytic:
        from .analytic import energy_and_forces, make_dense_params

        force_fn = partial(energy_and_forces, make_dense_params(system))
        if bias_fn is not None:
            force_fn = compose_bias(force_fn, bias_fn)
    else:
        from .forces import energy_and_forces_autograd

        force_fn = partial(energy_and_forces_autograd, system, bias_fn=bias_fn)
    return wrap_force_fn(force_fn, system)


def langevin_step(
    system: System,
    state: MDState,
    *,
    dt: float,
    friction: float,
    temperature_K,
    bias_fn: Optional[Callable] = None,
    force_fn: Optional[Callable] = None,
    constraints=None,
    force_state=None,
    replica_offset: int = 0,
):
    """One folded BAOAB step (OpenMM ``LangevinMiddleIntegrator``).
    Returns ``(new_state, energy at the pre-step positions)``.
    ``replica_offset`` is the global index of the batch's first replica
    (a rank's block of a sharded REMD), which keys its noise.

    ``bias_fn(positions) -> energy`` adds a bias to the autograd forces of
    ``potential_energy``; it cannot go with a ``force_fn``, which is used
    as it is (``make_force_fn`` and ``compose_bias`` put a bias into one).

    With ``force_state`` (a stateful force function's carry, the cell-list
    sweep's ``NeighborState``), ``force_fn`` must have the stateful
    signature ``fn(x, state) -> (energy, forces, state)`` and the return
    becomes ``(new_state, energy, new_force_state)``.

    B(dt): v += dt f/m ; A(dt/2) ; O ; A(dt/2). The kick is the FULL dt:
    the trailing half-kick of one step and the leading one of the next
    share the same x and merge, one force evaluation per step (a dt/2
    kick would sample exp(-U/2kT)). Reported velocities are offset by
    half a kick, as in OpenMM middle.

    With ``constraints`` (a spec of ``md.constraints``) the step runs
    in g-BAOAB order, as the JAX step does: RATTLE after the kick; SHAKE
    after each position half-step, with the correction folded into v and
    a RATTLE after it; RATTLE after the O step.

    Virtual sites: the autograd route composes their expansion into the
    energy (a given ``force_fn`` must spread their forces itself:
    ``vsites.wrap_force_fn``), and the sites are re-derived from their
    parents at the end of the step."""
    if force_fn is not None and bias_fn is not None:
        raise ValueError(
            "pass either force_fn or bias_fn, not both: a given force_fn is used "
            "as it is and the bias would be dropped")
    if force_state is not None:
        energy, f, force_state = force_fn(state.positions, force_state)
    elif force_fn is None:
        energy, f = expanded_energy_and_forces(system, state.positions, bias_fn)
    else:
        energy, f = force_fn(state.positions)
    inv_m = _inv_mass(system)
    v = state.velocities + dt * f * inv_m
    if constraints is not None:
        from .constraints import rattle, shake

        v = rattle(constraints, v, state.positions)
    x = state.positions + 0.5 * dt * v
    if constraints is not None:
        x_c = shake(constraints, x, state.positions)
        v = v + (x_c - x) / (0.5 * dt)
        x = x_c
        v = rattle(constraints, v, x)
    c1 = math.exp(-friction * dt)
    c2 = torch.sqrt((1.0 - c1 * c1) * _kT(temperature_K, v) * inv_m)
    noise = gaussian_noise(state.seeds, state.step, system.n_atoms, replica_offset)
    v = c1 * v + c2 * noise.to(v.dtype)
    if constraints is not None:
        v = rattle(constraints, v, x)
    x_pre = x
    x = x + 0.5 * dt * v
    if constraints is not None:
        x_c = shake(constraints, x, x_pre)
        v = v + (x_c - x) / (0.5 * dt)
        x = x_c
        v = rattle(constraints, v, x)
    vs = VirtualSites.from_system(system)
    if vs is not None:
        x = vs.expand(x)
    new_state = dataclasses.replace(state, positions=x, velocities=v,
                                    step=state.step + 1)
    if force_state is not None:
        return new_state, energy, force_state
    return new_state, energy


def run_md(
    system: System,
    state: MDState,
    *,
    n_steps: int,
    dt: float,
    friction: float,
    temperature_K,
    report_interval: int = 100,
    force_fn: Optional[Callable] = None,
    constraints=None,
    bias_fn: Optional[Callable] = None,
) -> Tuple[MDState, dict]:
    """Run ``n_steps`` and collect a frame every ``report_interval`` steps.

    Returns ``(final_state, report)``; the report holds tensors
    ``positions (F, ..., N, 3)``, ``potential_energy (F, ...)`` at the
    reported positions, and ``temperature (F, ...)`` from the velocities
    shifted by the trailing half-kick (a synchronized phase point, as
    OpenMM reports), less constrained degrees of freedom. ``force_fn``
    defaults to the analytic dense path (``md/analytic.py``) with
    ``bias_fn`` folded in; a given ``force_fn`` must already hold its bias
    (``md.setup.compose_bias``), so passing both raises. A stateful
    ``force_fn`` (the cell-list sweep: ``init_state`` / ``apply``) has its
    neighbour state threaded through the steps."""
    if n_steps % report_interval != 0:
        raise ValueError(
            f"n_steps {n_steps} must be a multiple of report_interval {report_interval}"
        )
    if force_fn is not None and bias_fn is not None:
        raise ValueError(
            "pass either force_fn or bias_fn, not both: compose the bias "
            "into the force_fn (md.setup.compose_bias)"
        )
    if force_fn is None:
        force_fn = make_force_fn(system, bias_fn)
    n_con = 0
    if constraints is not None:
        from .constraints import n_constraints, rattle

        n_con = n_constraints(constraints)
    inv_m = _inv_mass(system)
    init_state, apply = stateful_entries(force_fn, state.positions)
    fstate = None if init_state is None else init_state(state.positions)
    step_force = force_fn if apply is None else apply
    positions, energies, temps = [], [], []
    for _ in range(n_steps // report_interval):
        for _ in range(report_interval):
            out = langevin_step(
                system, state, dt=dt, friction=friction,
                temperature_K=temperature_K, force_fn=step_force,
                constraints=constraints, force_state=fstate,
            )
            state = out[0]
            if fstate is not None:
                fstate = out[2]
        # the energy at the REPORTED positions (the in-step energy is one
        # position update behind)
        if fstate is not None:
            e_now, f_now, fstate = step_force(state.positions, fstate)
        else:
            e_now, f_now = step_force(state.positions)
        v_sync = state.velocities + 0.5 * dt * f_now * inv_m
        if constraints is not None:
            v_sync = rattle(constraints, v_sync, state.positions)
        positions.append(state.positions)
        energies.append(e_now)
        # friction 0 is NVE: the COM momentum stays at thermalize()'s zero
        temps.append(instantaneous_temperature(
            system, v_sync, n_con, remove_com=(friction == 0.0)))
    return state, {
        "positions": torch.stack(positions),
        "potential_energy": torch.stack(energies),
        "temperature": torch.stack(temps),
    }


def thermalize(
    system: System, positions: torch.Tensor, generator: torch.Generator,
    temperature_K,
) -> MDState:
    """Fresh ``MDState`` with Maxwell-Boltzmann velocities (COM removed)
    and Philox seeds drawn from ``generator``. A tensor of temperatures
    ``(R,)`` thermalizes ``R`` replicas at ``positions (R, N, 3)``."""
    v = remove_com_motion(system, initialize_velocities(system, generator, temperature_K))
    shape = tuple(torch.as_tensor(temperature_K).shape)
    seeds = torch.randint(0, 2**31 - 1, shape, generator=generator,
                          device=system.device, dtype=torch.int64).to(torch.int32)
    return MDState(positions=positions, velocities=v, seeds=seeds, step=0)


__all__ = [
    "MDState", "langevin_step", "md_state_from_numpy", "run_md", "thermalize",
    "make_force_fn", "compose_bias", "bias_energy_and_forces", "stateful_entries",
    "initialize_velocities", "kinetic_energy",
    "instantaneous_temperature", "remove_com_motion",
    "gaussian_noise", "philox4x32_10",
]
