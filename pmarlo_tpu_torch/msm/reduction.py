"""Dimensionality reduction: PCA, TICA, VAMP from streaming covariances.

Port of ``pmarlo_tpu/msm/reduction.py``. The lagged products X0^T X0,
X0^T Xt and Xt^T Xt of each sequence are float32 matmuls on ``device``
(TF32 off: ``_precision.pin_fp32`` runs at package import), summed in
float64 on the host across sequences; the generalized eigensolves are small
symmetric problems solved in float64 numpy, as in JAX. ``ReductionModel``
holds numpy arrays, so a model fitted by either package transforms alike.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device
from ..utils.errors import EstimationError


@dataclasses.dataclass
class ReductionModel:
    """Fitted linear projection: y = (x - mean) @ components."""

    method: str
    mean: np.ndarray                 # (d,)
    components: np.ndarray           # (d, k)
    eigenvalues: np.ndarray          # (k,)
    lag: Optional[int] = None

    def transform(self, X) -> np.ndarray:
        X = np.asarray(X)
        return (X - self.mean) @ self.components

    def __call__(self, X):
        return self.transform(X)


def _streaming_moments(
    sequences: Sequence[np.ndarray], lag: int, *, device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Accumulate (C00, C0t, Ctt) sums over lagged pairs of all sequences.

    Each sequence's products and column sums are float32 on ``device``
    (``None``: ``_device.default_device()``) and come to the host in one
    copy, where they add up in float64.
    """
    dev = torch.device(device) if device is not None else default_device()
    d = int(np.asarray(sequences[0]).shape[1])
    C00 = np.zeros((d, d), dtype=np.float64)
    C0t = np.zeros((d, d), dtype=np.float64)
    Ctt = np.zeros((d, d), dtype=np.float64)
    s0 = np.zeros(d, dtype=np.float64)
    st = np.zeros(d, dtype=np.float64)
    n = 0
    for seq in sequences:
        X = torch.as_tensor(np.asarray(seq), dtype=torch.float32, device=dev)
        if X.shape[0] <= lag:
            continue
        X0, Xt = X[:-lag], X[lag:]
        sums = torch.cat([X0.T @ X0, X0.T @ Xt, Xt.T @ Xt,
                          X0.sum(0)[None], Xt.sum(0)[None]])
        sums = sums.cpu().numpy().astype(np.float64)
        C00 += sums[:d]
        C0t += sums[d:2 * d]
        Ctt += sums[2 * d:3 * d]
        s0 += sums[3 * d]
        st += sums[3 * d + 1]
        n += X0.shape[0]
    if n == 0:
        raise EstimationError(f"no lagged pairs at lag {lag}")
    mean0, meant = s0 / n, st / n
    C00 = C00 / n - np.outer(mean0, mean0)
    C0t = C0t / n - np.outer(mean0, meant)
    Ctt = Ctt / n - np.outer(meant, meant)
    return C00, C0t, Ctt, n


def _sym_inv_sqrt(C: np.ndarray, epsilon: float) -> np.ndarray:
    evals, evecs = np.linalg.eigh((C + C.T) / 2.0)
    keep = evals > epsilon
    if not keep.any():
        raise EstimationError("covariance matrix is numerically singular")
    return evecs[:, keep] @ np.diag(evals[keep] ** -0.5) @ evecs[:, keep].T


def pca(
    sequences: "np.ndarray | Sequence[np.ndarray]",
    n_components: int = 2,
) -> ReductionModel:
    seqs = _as_list(sequences)
    X = np.concatenate([np.asarray(s) for s in seqs], axis=0)
    mean = X.mean(axis=0)
    C = np.cov((X - mean).T)
    C = np.atleast_2d(C)
    evals, evecs = np.linalg.eigh(C)
    order = np.argsort(evals)[::-1][:n_components]
    return ReductionModel(
        method="pca", mean=mean, components=evecs[:, order],
        eigenvalues=evals[order],
    )


def tica(
    sequences: "np.ndarray | Sequence[np.ndarray]",
    lag: int,
    n_components: int = 2,
    epsilon: float = 1e-6,
    *,
    device=None,
) -> ReductionModel:
    """Time-lagged independent component analysis.

    Solves the symmetrized generalized eigenproblem
    0.5 (C0t + C0t^T) v = lambda C00 v via whitening (exact reversible
    TICA, matching deeptime's scaling="kinetic_map" direction order).
    """
    seqs = _as_list(sequences)
    C00, C0t, _, _ = _streaming_moments(seqs, lag, device=device)
    C0t_sym = 0.5 * (C0t + C0t.T)
    W = _sym_inv_sqrt(C00, epsilon)
    M = W @ C0t_sym @ W.T
    evals, evecs = np.linalg.eigh((M + M.T) / 2.0)
    order = np.argsort(evals)[::-1][:n_components]
    mean = _global_mean(seqs)
    return ReductionModel(
        method="tica", mean=mean, components=W.T @ evecs[:, order],
        eigenvalues=evals[order], lag=lag,
    )


def vamp(
    sequences: "np.ndarray | Sequence[np.ndarray]",
    lag: int,
    n_components: int = 2,
    epsilon: float = 1e-6,
    *,
    device=None,
) -> ReductionModel:
    """VAMP: SVD of C00^-1/2 C0t Ctt^-1/2; left singular functions."""
    seqs = _as_list(sequences)
    C00, C0t, Ctt, _ = _streaming_moments(seqs, lag, device=device)
    W0 = _sym_inv_sqrt(C00, epsilon)
    Wt = _sym_inv_sqrt(Ctt, epsilon)
    K = W0 @ C0t @ Wt.T
    U, S, Vt = np.linalg.svd(K)
    k = min(n_components, S.shape[0])
    mean = _global_mean(seqs)
    return ReductionModel(
        method="vamp", mean=mean, components=W0.T @ U[:, :k],
        eigenvalues=S[:k], lag=lag,
    )


def vamp2_score(
    sequences: "np.ndarray | Sequence[np.ndarray]", lag: int, epsilon: float = 1e-6,
    *, device=None,
) -> float:
    """VAMP-2 score = 1 + sum singular values^2 (constant included)."""
    seqs = _as_list(sequences)
    C00, C0t, Ctt, _ = _streaming_moments(seqs, lag, device=device)
    W0 = _sym_inv_sqrt(C00, epsilon)
    Wt = _sym_inv_sqrt(Ctt, epsilon)
    S = np.linalg.svd(W0 @ C0t @ Wt.T, compute_uv=False)
    return float(1.0 + np.sum(np.clip(S, 0.0, 1.0) ** 2))


def reduce_features(
    sequences: "np.ndarray | Sequence[np.ndarray]",
    method: str = "tica",
    *,
    lag: int = 10,
    n_components: int = 2,
    standardize: bool = True,
    device=None,
) -> Tuple[List[np.ndarray], ReductionModel]:
    """Reference-parity facade (reduction.py:152): NaN imputation +
    standardization + chosen reduction; returns transformed sequences.
    TICA and VAMP take their covariances on ``device``."""
    seqs = [np.array(s, dtype=np.float64, copy=True) for s in _as_list(sequences)]
    # NaN imputation with the column mean (reference reduction.py)
    stacked = np.concatenate(seqs, axis=0)
    col_mean = np.nanmean(stacked, axis=0)
    col_mean = np.where(np.isfinite(col_mean), col_mean, 0.0)
    for s in seqs:
        bad = ~np.isfinite(s)
        if bad.any():
            s[bad] = np.broadcast_to(col_mean, s.shape)[bad]
    if standardize:
        # moments from the IMPUTED data (a NaN/Inf input would otherwise
        # poison mu/sd and every downstream covariance)
        stacked = np.concatenate(seqs, axis=0)
        mu = stacked.mean(axis=0)
        sd = stacked.std(axis=0)
        sd[sd < 1e-12] = 1.0
        seqs = [(s - mu) / sd for s in seqs]
    if method == "pca":
        model = pca(seqs, n_components)
    elif method == "tica":
        model = tica(seqs, lag, n_components, device=device)
    elif method == "vamp":
        model = vamp(seqs, lag, n_components, device=device)
    else:
        raise ValueError(f"unknown reduction method {method!r}")
    out = [model.transform(s) for s in seqs]
    if standardize:
        # fold the standardization into the model so transform() applied
        # to RAW data reproduces `out`: ((x-mu)/sd - m)@C = (x-(mu+sd*m))@(C/sd)
        model = dataclasses.replace(
            model,
            mean=mu + sd * model.mean,
            components=model.components / sd[:, None],
        )
    return out, model


def _as_list(sequences) -> List[np.ndarray]:
    if isinstance(sequences, (list, tuple)):
        return [np.asarray(s) for s in sequences]
    return [np.asarray(sequences)]


def _global_mean(seqs: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(seqs, axis=0).mean(axis=0)


__all__ = [
    "ReductionModel",
    "pca",
    "tica",
    "vamp",
    "vamp2_score",
    "reduce_features",
]
