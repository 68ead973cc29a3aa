"""Folded BAOAB Langevin integration, batched over replicas.

Port of ``pmarlo_tpu/md/integrate.py``. Positions and velocities are
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
from typing import Callable, Optional, Tuple

import torch

from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from .forces import energy_and_forces_autograd
from .system import System, require_no_vsites

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


def gaussian_noise(seeds: torch.Tensor, step: int, n_atoms: int) -> torch.Tensor:
    """Standard normals ``seeds.shape + (n_atoms, 3)`` for one step.

    Philox key = (seed, replica index), counter = (step low word, step high
    word, atom, 0); the four output words give three normals by
    Box-Muller. The kernel computes the same numbers."""
    dev = seeds.device
    k0 = (seeds.reshape(-1).to(torch.int64) & _MASK32)[:, None]
    k1 = torch.arange(k0.shape[0], device=dev, dtype=torch.int64)[:, None]
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
    ``remove_com=True``, as in the JAX docstring."""
    require_no_vsites(system, "instantaneous_temperature")
    n_dof = max(
        3 * system.n_atoms - int(n_constraints) - (3 if remove_com else 0), 1
    )
    return 2.0 * kinetic_energy(system, velocities) / (
        n_dof * BOLTZMANN_CONSTANT_KJ_PER_MOL
    )


def remove_com_motion(system: System, velocities: torch.Tensor) -> torch.Tensor:
    m = system.masses[:, None]
    p = (m * velocities).sum(-2, keepdim=True)
    return velocities - p / system.masses.sum()


def langevin_step(
    system: System,
    state: MDState,
    *,
    dt: float,
    friction: float,
    temperature_K,
    force_fn: Optional[Callable] = None,
    constraints=None,
) -> Tuple[MDState, torch.Tensor]:
    """One folded BAOAB step (OpenMM ``LangevinMiddleIntegrator``).
    Returns ``(new_state, energy at the pre-step positions)``.

    B(dt): v += dt f/m ; A(dt/2) ; O ; A(dt/2). The kick is the FULL dt:
    the trailing half-kick of one step and the leading one of the next
    share the same x and merge, one force evaluation per step (a dt/2
    kick would sample exp(-U/2kT)). Reported velocities are offset by
    half a kick, as in OpenMM middle."""
    if constraints is not None:
        raise NotImplementedError(
            "SHAKE/RATTLE constraints are not ported yet (ROADMAP queue A11)"
        )
    require_no_vsites(system, "langevin_step")
    if force_fn is None:
        energy, f = energy_and_forces_autograd(system, state.positions)
    else:
        energy, f = force_fn(state.positions)
    inv_m = _inv_mass(system)
    v = state.velocities + dt * f * inv_m
    x = state.positions + 0.5 * dt * v
    c1 = math.exp(-friction * dt)
    c2 = torch.sqrt((1.0 - c1 * c1) * _kT(temperature_K, v) * inv_m)
    noise = gaussian_noise(state.seeds, state.step, system.n_atoms)
    v = c1 * v + c2 * noise.to(v.dtype)
    x = x + 0.5 * dt * v
    return dataclasses.replace(state, positions=x, velocities=v,
                               step=state.step + 1), energy


__all__ = [
    "MDState", "langevin_step", "initialize_velocities", "kinetic_energy",
    "instantaneous_temperature", "remove_com_motion",
    "gaussian_noise", "philox4x32_10",
]
