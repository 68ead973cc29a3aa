"""MSM numerical helpers: connectivity, lag ladders, transition-matrix checks.

TPU-native rebuild of reference src/pmarlo/utils/msm_utils.py:21,129,272.
These operate on small (n_states x n_states) matrices and run host-side in
NumPy by design — graph algorithms (SCC) are branch-heavy and tiny, so
keeping them off-device matches both the reference behavior and the TPU cost
model (SURVEY.md section 7 "hard parts").

Host copy of ``pmarlo_tpu/utils/msm_utils.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .scc import strongly_connected_components


def candidate_lag_ladder(
    max_lag: int, n_lags: int = 20, min_lag: int = 1
) -> List[int]:
    """Curated approximately-geometric lag ladder (reference msm_utils.py:21).

    Returns unique integer lags from ``min_lag`` to ``max_lag`` spaced
    geometrically — the standard ladder for implied-timescale scans.
    """
    if max_lag < min_lag:
        raise ValueError(f"max_lag {max_lag} < min_lag {min_lag}")
    raw = np.unique(
        np.round(
            np.geomspace(float(min_lag), float(max_lag), num=int(n_lags))
        ).astype(int)
    )
    return [int(x) for x in raw if min_lag <= x <= max_lag]


def ensure_connected_counts(
    counts: np.ndarray,
    alpha: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Restrict a count matrix to its largest strongly connected component.

    Returns ``(restricted_counts, active_states)`` where ``active_states``
    are indices into the original state space. An optional Dirichlet
    pseudocount ``alpha`` is added to observed-transition entries of the
    restricted matrix (reference utils/msm_utils.py:129).
    """
    counts = np.asarray(counts, dtype=np.float64)
    if counts.ndim != 2 or counts.shape[0] != counts.shape[1]:
        raise ValueError(f"counts must be square, got {counts.shape}")
    n = counts.shape[0]
    if n == 0:
        return counts.copy(), np.zeros(0, dtype=np.int64)

    adjacency = counts > 0
    components = strongly_connected_components(adjacency)
    # Pick the component with the largest total count mass (ties: size).
    best = max(
        components,
        key=lambda comp: (counts[np.ix_(comp, comp)].sum(), len(comp)),
    )
    active = np.asarray(sorted(best), dtype=np.int64)
    restricted = counts[np.ix_(active, active)].copy()
    if alpha > 0.0:
        restricted[restricted > 0] += alpha
    return restricted, active


def check_transition_matrix(
    T: np.ndarray, tol: float = 1e-8
) -> None:
    """Validate a row-stochastic transition matrix (reference :272).

    Raises ``ValueError`` on non-square shape, negative entries, or rows
    that do not sum to 1 within ``tol``.
    """
    T = np.asarray(T)
    if T.ndim != 2 or T.shape[0] != T.shape[1]:
        raise ValueError(f"transition matrix must be square, got {T.shape}")
    if not np.all(np.isfinite(T)):
        raise ValueError("transition matrix contains non-finite entries")
    if np.any(T < -tol):
        raise ValueError("transition matrix contains negative entries")
    row_sums = T.sum(axis=1)
    if not np.allclose(row_sums, 1.0, atol=tol):
        bad = np.argmax(np.abs(row_sums - 1.0))
        raise ValueError(
            f"row {bad} sums to {row_sums[bad]:.6g}, expected 1 +- {tol}"
        )


def stationary_distribution(T: np.ndarray) -> np.ndarray:
    """Stationary distribution of a row-stochastic matrix.

    Computed from the left eigenvector of the leading eigenvalue; falls back
    to power iteration if the eigensolve does not produce a clean
    probability vector.
    """
    T = np.asarray(T, dtype=np.float64)
    check_transition_matrix(T, tol=1e-6)
    evals, evecs = np.linalg.eig(T.T)
    idx = int(np.argmax(evals.real))
    pi = np.abs(evecs[:, idx].real)
    total = pi.sum()
    if not np.isfinite(total) or total <= 0:
        pi = np.full(T.shape[0], 1.0 / T.shape[0])
        for _ in range(10_000):
            nxt = pi @ T
            if np.linalg.norm(nxt - pi, 1) < 1e-14:
                pi = nxt
                break
            pi = nxt
        return pi / pi.sum()
    return pi / total


def lag_from_its_plateau(
    lags: np.ndarray,
    timescales: np.ndarray,
    rel_tol: float = 0.1,
) -> int:
    """Pick a lag where the slowest implied timescale plateaus.

    Longest window where the slowest ITS varies by <= rel_tol * window mean
    (reference utils/msm_utils.py:302 plateau rule). Returns the first lag of
    the best window, or the last lag if no plateau is found.
    """
    lags = np.asarray(lags)
    its = np.asarray(timescales, dtype=np.float64)
    if its.ndim == 2:
        its = its[:, 0]
    finite = np.isfinite(its)
    if finite.sum() < 2:
        return int(lags[-1])
    best_start, best_len = len(lags) - 1, 1
    n = len(lags)
    for start in range(n):
        if not finite[start]:
            continue
        for stop in range(start + 1, n + 1):
            window = its[start:stop]
            if not np.all(np.isfinite(window)):
                break
            mean = window.mean()
            if mean <= 0:
                break
            if (window.max() - window.min()) <= rel_tol * mean:
                if stop - start > best_len:
                    best_start, best_len = start, stop - start
            else:
                break
    return int(lags[best_start])


def macro_mfpt(
    T: np.ndarray, pi: np.ndarray, assignments: np.ndarray
) -> np.ndarray:
    """Mean first-passage times between macrostates via linear solves.

    ``assignments[i]`` is the macrostate of microstate i. MFPT from macro A
    to macro B solves (I - T_restricted) tau = 1 over states outside B, then
    averages over A weighted by pi (reference _msm_utils.py:138).
    """
    T = np.asarray(T, dtype=np.float64)
    pi = np.asarray(pi, dtype=np.float64)
    assignments = np.asarray(assignments)
    macros = np.unique(assignments)
    m = len(macros)
    out = np.zeros((m, m), dtype=np.float64)
    n = T.shape[0]
    for bi, B in enumerate(macros):
        target = assignments == B
        keep = ~target
        idx = np.where(keep)[0]
        if len(idx) == 0:
            continue
        A_mat = np.eye(len(idx)) - T[np.ix_(idx, idx)]
        tau_sub = np.linalg.solve(A_mat, np.ones(len(idx)))
        tau = np.zeros(n)
        tau[idx] = tau_sub
        for ai, A in enumerate(macros):
            if A == B:
                continue
            src = assignments == A
            w = pi[src]
            out[ai, bi] = float(np.average(tau[src], weights=w)) if w.sum() > 0 else np.nan
    return out


def macro_transition_matrix(
    T: np.ndarray, pi: np.ndarray, assignments: np.ndarray
) -> np.ndarray:
    """Lump a micro T into macro space: F_AB = sum_{i in A} pi_i T_ij / pi_A
    (reference _msm_utils.py:119)."""
    T = np.asarray(T, dtype=np.float64)
    pi = np.asarray(pi, dtype=np.float64)
    assignments = np.asarray(assignments)
    macros = np.unique(assignments)
    m = len(macros)
    out = np.zeros((m, m))
    for ai, A in enumerate(macros):
        in_a = assignments == A
        pa = pi[in_a].sum()
        if pa <= 0:
            continue
        flux = (pi[in_a, None] * T[in_a, :]).sum(axis=0)
        for bi, B in enumerate(macros):
            out[ai, bi] = flux[assignments == B].sum() / pa
    # normalize tiny numerical drift
    rows = out.sum(axis=1, keepdims=True)
    rows[rows == 0] = 1.0
    return out / rows


__all__ = [
    "candidate_lag_ladder",
    "ensure_connected_counts",
    "check_transition_matrix",
    "stationary_distribution",
    "lag_from_its_plateau",
    "macro_mfpt",
    "macro_transition_matrix",
]
