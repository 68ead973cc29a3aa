"""Implied timescales with Bayesian (Dirichlet) confidence intervals.

Port of ``pmarlo_tpu/msm/its.py`` (reference:
src/pmarlo/markov_state_model/_its.py:137-838 — per-lag posterior sampling
(default 100 samples), median + percentile CIs of timescales, NaN fill via
the deterministic reversible estimate, plateau detection).

Each transition-matrix row is Dirichlet(C_ij + prior), the exact conjugate
posterior of a multinomial row. The rows of all samples are drawn at once
on ``device`` in float32 from an explicit ``torch.Generator``, in log space
as JAX draws them: the concentrations of unvisited transitions are ~1e-4,
and a float32 gamma of that shape underflows (to 0, or on the CPU to the
smallest normal float), which leaves a row 0/0 or flat. The eigenvalues of
the small sampled matrices batch on the host.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device
from ..utils.errors import EstimationError
from ..utils.msm_utils import candidate_lag_ladder, ensure_connected_counts
from .counting import counts_from_dtrajs
from .estimation import estimate_transition_matrix


@dataclasses.dataclass
class ITSResult:
    """(reference results.py:135 ITSResult)."""

    lags: np.ndarray                     # (L,)
    timescales: np.ndarray               # (L, k) median over posterior
    ci_lower: np.ndarray                 # (L, k)
    ci_upper: np.ndarray                 # (L, k)
    n_samples: int
    plateau_lag: Optional[int] = None
    dt: float = 1.0

    def to_dict(self) -> Dict:
        return {
            "lags": self.lags.tolist(),
            "timescales": self.timescales.tolist(),
            "ci_lower": self.ci_lower.tolist(),
            "ci_upper": self.ci_upper.tolist(),
            "n_samples": self.n_samples,
            "plateau_lag": self.plateau_lag,
            "dt": self.dt,
        }


def _timescales_from_eigvals(evals: np.ndarray, lag: int, dt: float, k: int) -> np.ndarray:
    """Sorted |eigenvalues| (excluding the stationary one) -> timescales."""
    mags = np.sort(np.abs(evals), axis=-1)[..., ::-1]
    sub = mags[..., 1 : k + 1]
    sub = np.clip(sub, 1e-12, 1.0 - 1e-12)
    out = -lag * dt / np.log(sub)
    # pad if fewer states than k
    if sub.shape[-1] < k:
        pad = np.full(sub.shape[:-1] + (k - sub.shape[-1],), np.nan)
        out = np.concatenate([out, pad], axis=-1)
    return out


def _generator(generator: Optional[torch.Generator], seed: int, device) -> torch.Generator:
    """``generator``, or a new one on ``device`` (``None``: the default
    device) seeded with ``seed``."""
    if generator is not None:
        return generator
    dev = torch.device(device) if device is not None else default_device()
    return torch.Generator(device=dev).manual_seed(int(seed))


def log_gamma(alpha: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """log G, G ~ Gamma(alpha, 1), elementwise: log G(alpha + 1) +
    log(U) / alpha, U ~ U(0, 1], which stays finite where G itself would
    underflow (alpha << 1)."""
    g = torch._standard_gamma(alpha + 1.0, generator=generator)
    u = 1.0 - torch.rand(alpha.shape, generator=generator, dtype=alpha.dtype,
                         device=alpha.device)
    return torch.log(g) + torch.log(u) / alpha


def dirichlet_rows(alpha: torch.Tensor, n_samples: int,
                   generator: torch.Generator) -> torch.Tensor:
    """(n_samples, n, n): every row of every sample ~ Dirichlet of its row
    of ``alpha`` (n, n), as a softmax of log-gammas."""
    a = alpha.expand(n_samples, *alpha.shape).contiguous()
    return torch.softmax(log_gamma(a, generator), dim=-1)


def sample_posterior_timescales(
    counts: np.ndarray,
    lag: int,
    *,
    n_samples: int = 100,
    n_timescales: int = 5,
    prior: float = 1e-4,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    dt: float = 1.0,
    device=None,
) -> np.ndarray:
    """(n_samples, k) timescales sampled from the Dirichlet posterior.

    Reference behavior: BayesianMSM(n_samples=100) per lag
    (_its.py:289-312); here the conjugate posterior is sampled exactly.
    The rows are drawn on ``generator``'s device, or with a new generator
    seeded with ``seed`` on ``device``.
    """
    C, active = ensure_connected_counts(np.asarray(counts), alpha=0.0)
    n = C.shape[0]
    if n < 2:
        return np.full((n_samples, n_timescales), np.nan)
    generator = _generator(generator, seed, device)
    alpha = torch.as_tensor(C + prior, dtype=torch.float32, device=generator.device)
    rows = dirichlet_rows(alpha, n_samples, generator)
    T_samples = rows.cpu().numpy().astype(np.float64)
    evals = np.linalg.eigvals(T_samples)  # batched
    return _timescales_from_eigvals(evals, lag, dt, n_timescales)


def detect_plateau(
    lags: np.ndarray, its: np.ndarray, rel_epsilon: float = 0.15
) -> Optional[int]:
    """Longest window where the slowest ITS range <= eps * window mean
    (reference _its.py:803). Returns the first lag of the best window."""
    its0 = np.asarray(its)[:, 0]
    finite = np.isfinite(its0)
    best: Optional[Tuple[int, int]] = None  # (length, start)
    n = len(lags)
    for start in range(n):
        if not finite[start]:
            continue
        stop = start + 1
        while stop <= n and finite[start:stop].all():
            window = its0[start:stop]
            mean = window.mean()
            if mean > 0 and (window.max() - window.min()) <= rel_epsilon * mean:
                if best is None or (stop - start) > best[0]:
                    best = (stop - start, start)
                stop += 1
            else:
                break
    if best is None or best[0] < 2:
        return None
    return int(lags[best[1]])


def compute_implied_timescales(
    dtrajs: "np.ndarray | Sequence[np.ndarray]",
    lags: Optional[Sequence[int]] = None,
    *,
    n_states: Optional[int] = None,
    n_timescales: int = 5,
    n_samples: int = 100,
    ci: float = 0.95,
    seed: int = 0,
    dt: float = 1.0,
    count_mode: str = "sliding",
    reversible: bool = False,
    device=None,
) -> ITSResult:
    """ITS ladder with Bayesian CIs (reference _its.py:137).

    NaN medians are filled from the deterministic reversible estimate
    (reference :742).

    ``reversible=True`` samples the detailed-balance-constrained posterior
    (Gibbs sampler over symmetric flow matrices — the posterior deeptime's
    ``BayesianMSM`` samples for the reference, _its.py:289-312); the default
    ``False`` keeps the exact-conjugate independent Dirichlet-row posterior,
    which is cheaper but yields CI widths that are NOT comparable to the
    reference's on the same data (see msm/reversible_sampler.py).

    Every lag draws from one ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``None``: ``_device.default_device()``).
    """
    if isinstance(dtrajs, np.ndarray) and dtrajs.ndim == 1:
        dtrajs = [dtrajs]
    dtrajs = [np.asarray(d, dtype=np.int64) for d in dtrajs]
    if n_states is None:
        n_states = max((int(d.max()) for d in dtrajs if d.size), default=-1) + 1
    max_len = max((d.shape[0] for d in dtrajs), default=0)
    if lags is None:
        max_lag = max(max_len // 3, 2)
        lags = candidate_lag_ladder(max_lag, n_lags=20)
    lags = [int(l) for l in lags if l < max_len]
    if not lags:
        raise EstimationError("no feasible lags for trajectory lengths")

    lo_q = (1.0 - ci) / 2.0
    medians, lowers, uppers = [], [], []
    generator = _generator(None, seed, device)
    for lag in lags:
        C = counts_from_dtrajs(dtrajs, lag, n_states, count_mode=count_mode)
        if reversible:
            from .reversible_sampler import sample_reversible_timescales

            samples = sample_reversible_timescales(
                C, lag, n_samples=n_samples, n_timescales=n_timescales,
                generator=generator, dt=dt,
            )
        else:
            samples = sample_posterior_timescales(
                C, lag, n_samples=n_samples, n_timescales=n_timescales,
                generator=generator, dt=dt,
            )
        # columns beyond the connected-state count are NaN-padded by
        # design — the all-NaN reduction warning is not a data problem
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            med = np.nanmedian(samples, axis=0)
        # NaN fill from deterministic reversible estimate (reference :742)
        if np.isnan(med).any():
            try:
                C_a, _ = ensure_connected_counts(C)
                T, _ = estimate_transition_matrix(C_a, reversible=True)
                det = _timescales_from_eigvals(
                    np.linalg.eigvals(T), lag, dt, n_timescales
                )
                med = np.where(np.isnan(med), det, med)
            except EstimationError:
                pass
        medians.append(med)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            lowers.append(np.nanquantile(samples, lo_q, axis=0))
            uppers.append(np.nanquantile(samples, 1.0 - lo_q, axis=0))

    lags_arr = np.asarray(lags)
    its = np.asarray(medians)
    return ITSResult(
        lags=lags_arr,
        timescales=its,
        ci_lower=np.asarray(lowers),
        ci_upper=np.asarray(uppers),
        n_samples=n_samples,
        plateau_lag=detect_plateau(lags_arr, its),
        dt=dt,
    )


__all__ = [
    "ITSResult",
    "compute_implied_timescales",
    "sample_posterior_timescales",
    "detect_plateau",
]
