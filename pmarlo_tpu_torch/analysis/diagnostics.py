"""Shard diagnostics: autocorrelation times and CK-lag recommendations.

Reference: src/pmarlo/analysis/diagnostics.py:66 (per-shard autocorrelation
within segment boundaries), :90 (integrated tau_int and CK-lag
recommendation 2-5x tau_int), :22 (tau capped to 1/3 of shortest shard),
:585 compute_diagnostics, plus CCA-based CV comparison.

Host copy of ``pmarlo_tpu/analysis/diagnostics.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


def autocorrelation(x: np.ndarray, max_lag: Optional[int] = None) -> np.ndarray:
    """Normalized autocorrelation of a 1D series via FFT."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if n < 2:
        return np.ones(1)
    if max_lag is None:
        max_lag = n - 1
    xc = x - x.mean()
    f = np.fft.rfft(xc, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[: max_lag + 1]
    if acf[0] <= 0:
        return np.ones(max_lag + 1)
    return acf / acf[0]


def integrated_autocorrelation_time(
    x: np.ndarray, c: float = 5.0
) -> float:
    """tau_int with Sokal's adaptive windowing."""
    acf = autocorrelation(x)
    tau = 1.0
    for window in range(1, len(acf)):
        tau = 1.0 + 2.0 * np.sum(acf[1 : window + 1])
        if window >= c * tau:
            break
    return float(max(tau, 1.0))


@dataclasses.dataclass
class DiagnosticsResult:
    tau_int_per_column: List[float]
    tau_int_max: float
    recommended_lag_range: List[int]     # 2-5x tau_int (reference :90)
    max_usable_lag: int                  # 1/3 of shortest shard (reference :22)
    shortest_segment: int
    n_segments: int
    per_segment_tau: List[List[float]]

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def compute_diagnostics(
    dataset: "Sequence[np.ndarray] | Sequence[Dict]",
    max_columns: int = 8,
) -> DiagnosticsResult:
    """Per-shard, segment-bounded autocorrelation diagnostics
    (reference diagnostics.py:585)."""
    seqs: List[np.ndarray] = []
    for item in dataset:
        if isinstance(item, dict):
            seqs.append(np.asarray(item["features"]))
        else:
            seqs.append(np.asarray(item))
    if not seqs:
        raise ValueError("empty dataset")
    k = min(seqs[0].shape[1], max_columns)
    per_segment = []
    for s in seqs:
        per_segment.append([
            integrated_autocorrelation_time(s[:, j]) for j in range(k)
        ])
    arr = np.asarray(per_segment)  # (S, k)
    # pool per column as length-weighted mean
    lengths = np.asarray([len(s) for s in seqs], dtype=np.float64)
    w = lengths / lengths.sum()
    tau_cols = (arr * w[:, None]).sum(axis=0)
    tau_max = float(tau_cols.max())
    shortest = int(min(len(s) for s in seqs))
    return DiagnosticsResult(
        tau_int_per_column=[float(t) for t in tau_cols],
        tau_int_max=tau_max,
        recommended_lag_range=[int(np.ceil(2 * tau_max)), int(np.ceil(5 * tau_max))],
        max_usable_lag=max(shortest // 3, 1),
        shortest_segment=shortest,
        n_segments=len(seqs),
        per_segment_tau=[[float(t) for t in row] for row in per_segment],
    )


def derive_taus(
    dataset: "Sequence[np.ndarray] | Sequence[Dict] | Sequence[int]",
    *,
    max_lags: int = 10,
    min_lag: int = 1,
    fraction_max: float = 1.0 / 3.0,
    geometric: bool = True,
    base: "Sequence[int] | None" = None,
) -> List[int]:
    """Validated autocorrelation lag grid for a dataset
    (reference diagnostics.py:398 derive_taus).

    ``geometric``: log-spaced unique lags in
    [min_lag, fraction_max * shortest]; otherwise filter ``base`` to the
    usable range. Accepts shards (arrays/dicts) or raw segment lengths.
    """
    if max_lags < 1:
        raise ValueError("max_lags must be >= 1")
    if min_lag < 1:
        raise ValueError("min_lag must be >= 1")
    if not (0.0 < fraction_max <= 1.0):
        raise ValueError("fraction_max must be in (0, 1]")
    lengths: List[int] = []
    for item in dataset:
        if isinstance(item, dict):
            lengths.append(int(np.asarray(item["features"]).shape[0]))
        elif np.isscalar(item) or isinstance(item, (int, np.integer)):
            lengths.append(int(item))
        else:
            lengths.append(int(np.asarray(item).shape[0]))
    if not lengths:
        raise ValueError("empty dataset")
    min_length = min(lengths)
    if min_length <= min_lag:
        raise ValueError(
            f"shortest segment ({min_length}) must exceed min_lag ({min_lag})"
        )
    if geometric:
        upper = int(max(min_lag + 1, np.floor(min_length * fraction_max)))
        upper = min(upper, min_length - 1)
        if upper <= min_lag:
            raise ValueError(
                f"usable upper bound {upper} not greater than "
                f"min_lag {min_lag}"
            )
        raw = np.exp(np.linspace(np.log(min_lag), np.log(upper),
                                 num=max_lags))
        taus, last = [], 0
        for cand in (int(round(v)) for v in raw):
            if min_lag <= cand < min_length and cand > last:
                taus.append(cand)
                last = cand
        if not taus:
            raise ValueError("geometric tau derivation yielded empty set")
        return taus
    if base is None:
        raise ValueError("base lags required when geometric=False")
    taus = sorted({int(b) for b in base
                   if min_lag <= int(b) < min_length})
    if not taus:
        raise ValueError("no base lag fits the usable range")
    return taus


def cca_similarity(X: np.ndarray, Y: np.ndarray, n_components: int = 2) -> List[float]:
    """Canonical correlations between two CV sets (reference CCA comparison).

    Measures whether two CV models span the same slow subspace.
    """
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    X = X - X.mean(axis=0)
    Y = Y - Y.mean(axis=0)
    n = X.shape[0]
    Cxx = X.T @ X / n + 1e-8 * np.eye(X.shape[1])
    Cyy = Y.T @ Y / n + 1e-8 * np.eye(Y.shape[1])
    Cxy = X.T @ Y / n

    def inv_sqrt(C):
        e, v = np.linalg.eigh(C)
        e = np.maximum(e, 1e-12)
        return v @ np.diag(e**-0.5) @ v.T

    M = inv_sqrt(Cxx) @ Cxy @ inv_sqrt(Cyy)
    s = np.linalg.svd(M, compute_uv=False)
    return [float(v) for v in np.clip(s[:n_components], 0, 1)]


__all__ = [
    "autocorrelation",
    "integrated_autocorrelation_time",
    "DiagnosticsResult",
    "compute_diagnostics",
    "cca_similarity",
]
