"""Acceptance-targeted temperature ladders for REMD.

Port of ``pmarlo_tpu/remd/ladder.py``: short MD probes at a few
temperatures give E(T) and sigma_E(T) (detrended, autocorrelation-
corrected, extended while under-sampled); each next rung is bisected so
that the Gaussian two-rung acceptance

    P = Phi(mu/s) + exp(mu + s^2/2) * Phi(-mu/s - s),
    mu = (b1 - b2)(E1bar - E2bar),  s = |b1 - b2| sqrt(s1^2 + s2^2)

meets the target. The probes run as one batch of replicas through
``md.integrate.langevin_step`` (the port's noise stream, so their numbers
are not JAX's); the model and the walk are the JAX code's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL as KB


def _phi(z: float) -> float:
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def predicted_acceptance(
    T1: float, T2: float,
    e_mean: Callable[[float], float],
    e_std: Callable[[float], float],
) -> float:
    """Gaussian-model swap acceptance between rungs at T1 < T2."""
    b1, b2 = 1.0 / (KB * T1), 1.0 / (KB * T2)
    mu = (b1 - b2) * (e_mean(T1) - e_mean(T2))     # <= 0 (E rises with T)
    s = abs(b1 - b2) * math.sqrt(e_std(T1) ** 2 + e_std(T2) ** 2)
    if s < 1e-12:
        return 1.0
    # E[min(1, e^X)] for X ~ N(mu, s^2)
    return _phi(mu / s) + math.exp(min(mu + 0.5 * s * s, 50.0)) * _phi(
        -mu / s - s
    )


@dataclasses.dataclass
class LadderProbe:
    """Measured E(T) statistics from the probe runs; ``e_std`` is the
    autocorrelation-corrected fluctuation magnitude."""

    temperatures: np.ndarray   # (P,)
    e_mean: np.ndarray         # (P,)
    e_std: np.ndarray          # (P,) ESS-corrected sigma_E
    tau_int: Optional[np.ndarray] = None     # (P,) steps
    ess: Optional[np.ndarray] = None         # (P,) W / (2 tau_int)
    probe_steps_used: int = 0

    def mean_at(self, T: float) -> float:
        return float(np.interp(T, self.temperatures, self.e_mean))

    def std_at(self, T: float) -> float:
        return float(np.interp(T, self.temperatures, self.e_std))


def probe_energy_statistics(
    system,
    positions: torch.Tensor,
    temperatures: Sequence[float],
    *,
    probe_steps: int = 600,
    dt_ps: float = 0.002,
    friction_per_ps: float = 1.0,
    seed: int = 0,
    force_fn: Optional[Callable] = None,
    constraints=None,
    min_ess: float = 20.0,
    max_extensions: int = 2,
) -> LadderProbe:
    """MD at each probe temperature (one replica each, batched) from
    ``positions (N, 3)``; energy statistics over the second half of each
    probe. The tail is detrended before sigma_E is taken, tau_int corrects
    the correlated-sample bias, and the probe is rerun with twice the
    steps (up to ``max_extensions`` times) while an effective sample size
    is below ``min_ess`` or the tail still drifts."""
    from ..analysis.diagnostics import integrated_autocorrelation_time
    from ..md.integrate import langevin_step, stateful_entries, thermalize

    dev = positions.device
    temps = torch.as_tensor(list(temperatures), dtype=torch.float32, device=dev)
    P = int(temps.shape[0])
    x0 = positions[None].expand((P,) + tuple(positions.shape)).contiguous()

    def run_probes(steps: int) -> np.ndarray:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        st = thermalize(system, x0, gen, temps)
        init_state, apply = stateful_entries(force_fn, x0)
        fstate = None if init_state is None else init_state(x0)
        energies = []
        for _ in range(steps):
            out = langevin_step(
                system, st, dt=dt_ps, friction=friction_per_ps,
                temperature_K=temps, force_fn=force_fn if apply is None else apply,
                constraints=constraints, force_state=fstate,
            )
            st = out[0]
            if fstate is not None:
                fstate = out[2]
            energies.append(out[1])
        return torch.stack(energies, 1).double().cpu().numpy()

    steps = int(probe_steps)
    for _ in range(max_extensions + 1):
        energies = run_probes(steps)
        if not np.isfinite(energies).all():
            raise ValueError(
                "probe runs produced non-finite energies — minimize the "
                "structure before probing (pass minimized positions)"
            )
        tails = energies[:, steps // 2:]
        W = tails.shape[1]
        t_idx = np.arange(W, dtype=np.float64)
        means = np.empty(P)
        sigmas = np.empty(P)
        taus = np.empty(P)
        drifting = False
        for p in range(P):
            y = tails[p]
            slope, intercept = np.polyfit(t_idx, y, 1)
            resid = y - (slope * t_idx + intercept)
            s = float(resid.std())
            tau = integrated_autocorrelation_time(resid)
            means[p] = float(y.mean())
            taus[p] = tau
            # correlated-window bias correction, floored at 2x
            corr = max(1.0 - 2.0 * tau / W, 0.25)
            sigmas[p] = s / math.sqrt(corr)
            if abs(slope) * W > 2.0 * max(s, 1e-12):
                drifting = True
        ess = W / (2.0 * taus)
        if not drifting and float(ess.min()) >= min_ess:
            break
        steps *= 2
    return LadderProbe(
        temperatures=temps.double().cpu().numpy(),
        e_mean=means,
        e_std=sigmas,
        tau_int=taus,
        ess=ess,
        probe_steps_used=steps,
    )


def suggest_temperature_ladder(
    system,
    positions: torch.Tensor,
    *,
    t_min: float = 300.0,
    t_max: float = 360.0,
    target_acceptance: float = 0.3,
    max_rungs: int = 128,
    n_probe: int = 4,
    probe_steps: int = 600,
    dt_ps: float = 0.002,
    friction_per_ps: float = 1.0,
    seed: int = 0,
    force_fn: Optional[Callable] = None,
    constraints=None,
    probe: Optional[LadderProbe] = None,
) -> Tuple[np.ndarray, List[float]]:
    """A ladder hitting ``target_acceptance`` between neighbours:
    ``(ladder (R,), predicted acceptances (R-1,))``. ``probe`` reuses
    measured statistics instead of running the probes."""
    if not (0.0 < target_acceptance < 1.0):
        raise ValueError("target_acceptance must be in (0, 1)")
    if t_max <= t_min:
        raise ValueError("t_max must exceed t_min")
    if probe is None:
        # geometric probe temperatures (ladders are ~geometric)
        ratio = (t_max / t_min) ** (1.0 / max(n_probe - 1, 1))
        probe_temps = [t_min * ratio**i for i in range(n_probe)]
        probe = probe_energy_statistics(
            system, positions, probe_temps, probe_steps=probe_steps,
            dt_ps=dt_ps, friction_per_ps=friction_per_ps, seed=seed,
            force_fn=force_fn, constraints=constraints,
        )

    ladder = [float(t_min)]
    predicted: List[float] = []
    while ladder[-1] < t_max and len(ladder) < max_rungs:
        T1 = ladder[-1]

        def acc(T2: float) -> float:
            return predicted_acceptance(T1, T2, probe.mean_at, probe.std_at)

        if acc(t_max) >= target_acceptance:
            ladder.append(float(t_max))
            predicted.append(acc(t_max))
            break
        lo, hi = T1 * (1.0 + 1e-6), float(t_max)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if acc(mid) > target_acceptance:
                lo = mid
            else:
                hi = mid
        T2 = 0.5 * (lo + hi)
        ladder.append(T2)
        predicted.append(acc(T2))
    if ladder[-1] < t_max:
        raise ValueError(
            f"acceptance-targeted ladder needs more than max_rungs="
            f"{max_rungs} rungs to span [{t_min}, {t_max}] K at target "
            f"acceptance {target_acceptance} (reached {ladder[-1]:.1f} K "
            f"after {len(ladder)} rungs) — raise max_rungs, lower the "
            "target acceptance, or narrow the temperature range"
        )
    return np.asarray(ladder, np.float64), predicted


__all__ = [
    "LadderProbe", "predicted_acceptance", "probe_energy_statistics",
    "suggest_temperature_ladder",
]
