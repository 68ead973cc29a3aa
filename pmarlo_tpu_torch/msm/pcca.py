"""PCCA+ spectral lumping of microstates into metastable macrostates.

Replaces deeptime's pcca (reference:
src/pmarlo/markov_state_model/_msm_utils.py:284 — PCCA+ labels
canonicalized by population, with eigenvector-KMeans fallback at
_states.py:159). Host-side NumPy by design: n_states is small and the
inner optimization is branch-heavy (SURVEY.md section 7).

Implementation: Roeblitz-Weber PCCA+ — pi-weighted eigenvectors of the
reversible T, simplex vertex seeding (inner simplex algorithm), then crisp
assignment by maximal membership.

Host copy of ``pmarlo_tpu/msm/pcca.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.errors import EstimationError
from ..utils.msm_utils import stationary_distribution


def _reversible_eigenvectors(
    T: np.ndarray, pi: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Right eigenvectors of a reversible T via pi-symmetrization.

    T_sym = D^1/2 T D^-1/2 (D = diag(pi)) is symmetric for detailed-balance
    T; eigh gives stable sorted spectra (the reference's own trick,
    _its.py:742-801).
    """
    sqrt_pi = np.sqrt(np.maximum(pi, 1e-300))
    T_sym = sqrt_pi[:, None] * T / sqrt_pi[None, :]
    T_sym = 0.5 * (T_sym + T_sym.T)
    evals, evecs_sym = np.linalg.eigh(T_sym)
    order = np.argsort(evals)[::-1]
    evals = evals[order[:k]]
    evecs = evecs_sym[:, order[:k]] / sqrt_pi[:, None]
    # normalize so the first eigenvector is exactly 1
    evecs[:, 0] = 1.0
    return evals, evecs


def pcca_memberships(
    T: np.ndarray,
    n_macrostates: int,
    pi: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fuzzy memberships chi (n_states, n_macrostates), rows sum to 1."""
    T = np.asarray(T, dtype=np.float64)
    n = T.shape[0]
    m = int(n_macrostates)
    if m < 2:
        raise EstimationError("need at least 2 macrostates")
    if m > n:
        raise EstimationError(f"{m} macrostates > {n} microstates")
    if pi is None:
        pi = stationary_distribution(T)
    pi = np.asarray(pi, dtype=np.float64)

    _, evecs = _reversible_eigenvectors(T, pi, m)

    # inner simplex algorithm: pick m rows of the eigenvector matrix that
    # span the largest simplex (Roeblitz & Weber 2013)
    X = evecs.copy()
    vertices = np.zeros(m, dtype=np.int64)
    # first vertex: farthest from origin in the non-trivial coords
    norms = np.linalg.norm(X[:, 1:], axis=1)
    vertices[0] = int(np.argmax(norms))
    Y = X - X[vertices[0]]
    for i in range(1, m):
        norms = np.linalg.norm(Y[:, 1:], axis=1)
        vertices[i] = int(np.argmax(norms))
        v = Y[vertices[i], 1:]
        nv = np.linalg.norm(v)
        if nv < 1e-12:
            # degenerate spectrum: fall back to k-means on eigenvectors
            return _kmeans_fallback_memberships(evecs, m)
        v = v / nv
        Y[:, 1:] -= np.outer(Y[:, 1:] @ v, v)

    A = X[vertices]  # (m, m)
    try:
        chi = X @ np.linalg.inv(A)
    except np.linalg.LinAlgError:
        return _kmeans_fallback_memberships(evecs, m)
    # clip tiny negatives from the linear solve, renormalize
    chi = np.clip(chi, 0.0, None)
    rows = chi.sum(axis=1, keepdims=True)
    rows[rows == 0] = 1.0
    return chi / rows


def _kmeans_fallback_memberships(evecs: np.ndarray, m: int) -> np.ndarray:
    """Eigenvector k-means fallback (reference _states.py:159)."""
    from .clustering import kmeans

    _, labels, _ = kmeans(evecs[:, 1:], m, seed=0, n_iter=100)
    chi = np.zeros((evecs.shape[0], m))
    chi[np.arange(evecs.shape[0]), labels] = 1.0
    return chi


def pcca_assignments(
    T: np.ndarray,
    n_macrostates: int,
    pi: Optional[np.ndarray] = None,
    canonical_order: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Crisp macrostate labels + memberships.

    ``canonical_order``: relabel macrostates by decreasing population
    (reference _msm_utils.py:284 canonicalization).
    """
    if pi is None:
        pi = stationary_distribution(np.asarray(T, dtype=np.float64))
    chi = pcca_memberships(T, n_macrostates, pi)
    labels = np.argmax(chi, axis=1)
    if canonical_order:
        pops = np.array([pi[labels == c].sum() for c in range(chi.shape[1])])
        order = np.argsort(-pops)
        remap = np.empty_like(order)
        remap[order] = np.arange(len(order))
        labels = remap[labels]
        chi = chi[:, order]
    return labels, chi


__all__ = ["pcca_memberships", "pcca_assignments"]
