"""Transition-matrix estimation: non-reversible and reversible MLE.

Replaces deeptime's MaximumLikelihoodMSM (reference:
src/pmarlo/markov_state_model/_estimation.py:50-211 — lag validation,
SCC restriction via ensure_connected_counts, estimation, embedding back
into the full state space, free energies -kT ln pi).

The reversible MLE uses the standard self-consistent iteration
(Bowman/Prinz x_ij update) on the restricted count matrix — a fixed-point
loop over small dense matrices, run in float64 on host (n_states is at
most a few hundred; device round-trips would dominate).

Host copy of ``pmarlo_tpu/msm/estimation.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from ..utils.errors import EstimationError
from ..utils.msm_utils import ensure_connected_counts, stationary_distribution
from .counting import counts_from_dtrajs


@dataclasses.dataclass
class MSMResult:
    """Reference-parity result (markov_state_model/results.py:112)."""

    transition_matrix: np.ndarray      # (n, n) full state space
    stationary_distribution: np.ndarray
    counts: np.ndarray
    lag: int
    active_states: np.ndarray          # indices of the connected set
    n_states: int
    free_energies: Optional[np.ndarray] = None   # -kT ln pi (kJ/mol)
    reversible: bool = True

    def timescales(self, n: int = 10, dt: float = 1.0) -> np.ndarray:
        evals = np.sort(np.abs(np.linalg.eigvals(self.restricted_T())))[::-1]
        evals = np.clip(evals[1 : n + 1], 1e-12, 1.0 - 1e-12)
        return -self.lag * dt / np.log(evals)

    def restricted_T(self) -> np.ndarray:
        return self.transition_matrix[np.ix_(self.active_states, self.active_states)]

    def to_dict(self) -> Dict:
        return {
            "lag": self.lag,
            "n_states": self.n_states,
            "n_active": len(self.active_states),
            "reversible": self.reversible,
        }


def _row_normalize(counts: np.ndarray) -> np.ndarray:
    rows = counts.sum(axis=1, keepdims=True)
    rows[rows == 0] = 1.0
    return counts / rows


def reversible_mle(
    counts: np.ndarray, n_iter: int = 1000, tol: float = 1e-10
) -> np.ndarray:
    """Reversible MLE transition matrix via the self-consistent x-update.

    Maximizes prod T_ij^{C_ij} under detailed balance. x_ij = pi_i T_ij is
    updated as x_ij = (C_ij + C_ji) / (C_i/x_i + C_j/x_j); converged x is
    normalized to T. Standard algorithm (Prinz et al. JCP 134, 174105).
    """
    C = np.asarray(counts, dtype=np.float64)
    n = C.shape[0]
    if n == 0:
        raise EstimationError("empty count matrix")
    C_sym = C + C.T
    x = C_sym.copy()
    x /= max(x.sum(), 1e-300)
    c_row = C.sum(axis=1)
    for _ in range(n_iter):
        x_row = x.sum(axis=1)
        q = c_row / np.maximum(x_row, 1e-300)
        denom = q[:, None] + q[None, :]
        x_new = np.where(C_sym > 0, C_sym / np.maximum(denom, 1e-300), 0.0)
        total = max(x_new.sum(), 1e-300)
        x_new /= total
        delta = np.abs(x_new - x).max()
        x = x_new
        if delta < tol:
            break
    T = _row_normalize(x)
    return T


def estimate_transition_matrix(
    counts: np.ndarray, reversible: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """(T, pi) from a (connected) count matrix."""
    counts = np.asarray(counts, dtype=np.float64)
    if reversible:
        T = reversible_mle(counts)
        # pi from T itself (exact stationarity)
        pi = stationary_distribution(T)
    else:
        T = _row_normalize(counts)
        pi = stationary_distribution(T)
    return T, pi


def build_msm(
    dtrajs: "np.ndarray | Sequence[np.ndarray]",
    lag: int,
    n_states: Optional[int] = None,
    *,
    reversible: bool = True,
    count_mode: str = "sliding",
    alpha: float = 0.0,
    temperature_K: float = 300.0,
) -> MSMResult:
    """Full estimation pipeline: count -> SCC restrict -> MLE -> embed.

    Mirrors reference _estimation.py:50 (build_msm): lag capping against
    trajectory lengths is the caller's job; free energies are -kT ln pi
    with non-active states at +inf (reference :211).
    """
    if isinstance(dtrajs, np.ndarray) and dtrajs.ndim == 1:
        dtrajs = [dtrajs]
    dtrajs = [np.asarray(d, dtype=np.int64) for d in dtrajs]
    if n_states is None:
        n_states = max((int(d.max()) for d in dtrajs if d.size), default=-1) + 1
    max_len = max((d.shape[0] for d in dtrajs), default=0)
    if lag >= max_len:
        raise EstimationError(
            f"lag {lag} >= longest trajectory ({max_len} frames)"
        )
    C_full = counts_from_dtrajs(dtrajs, lag, n_states, count_mode=count_mode)
    if C_full.sum() == 0:
        raise EstimationError("no transitions counted (all-invalid labels?)")
    C_active, active = ensure_connected_counts(C_full, alpha=alpha)
    T_active, pi_active = estimate_transition_matrix(C_active, reversible=reversible)

    # embed back into the full state space (reference :158-210)
    T = np.eye(n_states, dtype=np.float64)
    T[np.ix_(active, active)] = T_active
    pi = np.zeros(n_states, dtype=np.float64)
    pi[active] = pi_active

    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * temperature_K
    with np.errstate(divide="ignore"):
        F = np.where(pi > 0, -kT * np.log(np.maximum(pi, 1e-300)), np.inf)
    F[np.isfinite(F)] -= F[np.isfinite(F)].min() if np.isfinite(F).any() else 0.0

    return MSMResult(
        transition_matrix=T,
        stationary_distribution=pi,
        counts=C_full,
        lag=int(lag),
        active_states=active,
        n_states=int(n_states),
        free_energies=F,
        reversible=reversible,
    )


def build_simple_msm(
    dtrajs, lag: int, n_states: Optional[int] = None, reversible: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """(T, pi) shortcut (reference _msm_utils.py:163 / bridge.py:20)."""
    r = build_msm(dtrajs, lag, n_states, reversible=reversible)
    return r.transition_matrix, r.stationary_distribution


__all__ = [
    "MSMResult",
    "build_msm",
    "build_simple_msm",
    "estimate_transition_matrix",
    "reversible_mle",
]
