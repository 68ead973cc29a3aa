"""Transition-path theory: committors, reactive flux, rates, MFPT, pathways.

Replaces deeptime's reactive_flux (reference:
src/pmarlo/markov_state_model/_tpt.py:29-162 and
conformations/tpt_analysis.py:31-135). Committors are linear solves; flux
decomposition into pathways is the standard iterative bottleneck-removal
algorithm (host-side — tiny graphs, branch-heavy).

Host copy of ``pmarlo_tpu/msm/tpt.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import EstimationError
from ..utils.msm_utils import stationary_distribution


@dataclasses.dataclass
class TPTResult:
    """(reference conformations/results.py:14 TPTResult)."""

    source_states: np.ndarray
    sink_states: np.ndarray
    forward_committor: np.ndarray
    backward_committor: np.ndarray
    gross_flux: np.ndarray
    net_flux: np.ndarray
    total_flux: float
    rate: float
    mfpt: float
    pathways: List[Tuple[List[int], float]]
    pathway_convergence_warning: Optional[str] = None

    def to_dict(self) -> Dict:
        return {
            "source_states": self.source_states.tolist(),
            "sink_states": self.sink_states.tolist(),
            "total_flux": self.total_flux,
            "rate": self.rate,
            "mfpt": self.mfpt,
            "n_pathways": len(self.pathways),
            "pathways": [
                {"path": p, "flux": f} for p, f in self.pathways
            ],
        }


def committors(
    T: np.ndarray, source: Sequence[int], sink: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """(q_plus, q_minus) via linear solves (reference _tpt.py:109)."""
    T = np.asarray(T, dtype=np.float64)
    n = T.shape[0]
    A = np.asarray(sorted(set(int(s) for s in source)))
    B = np.asarray(sorted(set(int(s) for s in sink)))
    if np.intersect1d(A, B).size:
        raise EstimationError("source and sink states overlap")
    inter = np.asarray([i for i in range(n) if i not in set(A) | set(B)])

    # forward committor: q+ = 0 on A, 1 on B, (I - T) q+ = 0 elsewhere
    qp = np.zeros(n)
    qp[B] = 1.0
    if inter.size:
        M = np.eye(len(inter)) - T[np.ix_(inter, inter)]
        rhs = T[np.ix_(inter, B)].sum(axis=1)
        qp[inter] = np.linalg.solve(M, rhs)

    # backward committor via the time-reversed chain
    pi = stationary_distribution(T)
    pi_safe = np.maximum(pi, 1e-300)
    T_rev = (pi_safe[None, :] * T.T) / pi_safe[:, None]
    T_rev /= np.maximum(T_rev.sum(axis=1, keepdims=True), 1e-300)
    qm = np.zeros(n)
    qm[A] = 1.0
    if inter.size:
        M = np.eye(len(inter)) - T_rev[np.ix_(inter, inter)]
        rhs = T_rev[np.ix_(inter, A)].sum(axis=1)
        qm[inter] = np.linalg.solve(M, rhs)
    return np.clip(qp, 0.0, 1.0), np.clip(qm, 0.0, 1.0)


def reactive_flux(
    T: np.ndarray,
    source: Sequence[int],
    sink: Sequence[int],
    pi: Optional[np.ndarray] = None,
    n_pathways: int = 10,
    pathway_fraction: float = 0.99,
    maxiter: int = 10_000,
) -> TPTResult:
    """Full TPT analysis (reference _tpt.py:39 reactive_flux;
    pathway decomposition with convergence-warning capture per
    conformations/tpt_analysis.py:31)."""
    T = np.asarray(T, dtype=np.float64)
    if pi is None:
        pi = stationary_distribution(T)
    pi = np.asarray(pi, dtype=np.float64)
    A = np.asarray(sorted(set(int(s) for s in source)))
    B = np.asarray(sorted(set(int(s) for s in sink)))
    qp, qm = committors(T, A, B)

    # gross flux f_ij = pi_i q-_i T_ij q+_j (i != j)
    F = pi[:, None] * qm[:, None] * T * qp[None, :]
    np.fill_diagonal(F, 0.0)
    # net flux
    Fnet = np.maximum(F - F.T, 0.0)

    total_flux = float(F[A, :].sum() - F[:, A][A].sum()) if A.size else 0.0
    # canonical total flux: flux out of A
    total_flux = float(Fnet[A, :].sum())
    denom = float(np.sum(pi * qm))
    rate = total_flux / denom if denom > 0 else np.nan
    mfpt = 1.0 / rate if rate and rate > 0 else np.inf

    pathways, warning = _decompose_pathways(
        Fnet.copy(), A, B, total_flux, n_pathways, pathway_fraction, maxiter
    )
    return TPTResult(
        source_states=A, sink_states=B,
        forward_committor=qp, backward_committor=qm,
        gross_flux=F, net_flux=Fnet, total_flux=total_flux,
        rate=rate, mfpt=mfpt, pathways=pathways,
        pathway_convergence_warning=warning,
    )


def _widest_path(F: np.ndarray, A: np.ndarray, B: np.ndarray) -> Optional[List[int]]:
    """Max-bottleneck path from any A to any B (Dijkstra-style)."""
    n = F.shape[0]
    width = np.full(n, -np.inf)
    prev = np.full(n, -1, dtype=np.int64)
    width[A] = np.inf
    visited = np.zeros(n, dtype=bool)
    for _ in range(n):
        candidates = np.where(~visited, width, -np.inf)
        u = int(np.argmax(candidates))
        if candidates[u] <= 0:
            break
        visited[u] = True
        if u in set(B.tolist()):
            path = [u]
            while prev[path[-1]] != -1:
                path.append(int(prev[path[-1]]))
            path = path[::-1]
            # ensure it starts in A (source widths are inf with prev -1)
            return path
        w_new = np.minimum(width[u], F[u])
        better = (w_new > width) & ~visited
        width = np.where(better, w_new, width)
        prev = np.where(better, u, prev)
    return None


def _decompose_pathways(
    Fnet: np.ndarray,
    A: np.ndarray,
    B: np.ndarray,
    total_flux: float,
    n_pathways: int,
    fraction: float,
    maxiter: int,
) -> Tuple[List[Tuple[List[int], float]], Optional[str]]:
    """Iterative bottleneck decomposition of the net flux network."""
    pathways: List[Tuple[List[int], float]] = []
    accounted = 0.0
    warning = None
    for it in range(maxiter):
        if len(pathways) >= n_pathways:
            break
        if total_flux > 0 and accounted / total_flux >= fraction:
            break
        path = _widest_path(Fnet, A, B)
        if path is None or len(path) < 2:
            break
        bottleneck = min(Fnet[path[i], path[i + 1]] for i in range(len(path) - 1))
        if bottleneck <= 0:
            break
        for i in range(len(path) - 1):
            Fnet[path[i], path[i + 1]] -= bottleneck
        pathways.append((path, float(bottleneck)))
        accounted += bottleneck
    else:
        warning = f"pathway decomposition hit maxiter={maxiter}"
    if total_flux > 0 and accounted / total_flux < fraction and warning is None:
        if len(pathways) >= n_pathways:
            pass  # requested count reached; remaining flux is fine
        else:
            warning = (
                f"pathways cover {accounted / total_flux:.1%} < {fraction:.0%} of flux"
            )
    return pathways, warning


def mfpt_matrix(T: np.ndarray, dt: float = 1.0) -> np.ndarray:
    """All-pairs MFPT by per-target linear solves (small n)."""
    T = np.asarray(T, dtype=np.float64)
    n = T.shape[0]
    out = np.zeros((n, n))
    for j in range(n):
        keep = np.asarray([i for i in range(n) if i != j])
        M = np.eye(n - 1) - T[np.ix_(keep, keep)]
        tau = np.linalg.solve(M, np.ones(n - 1)) * dt
        out[keep, j] = tau
    return out


__all__ = ["TPTResult", "committors", "reactive_flux", "mfpt_matrix"]
