"""Lagged (t, t+tau) index pairs (reference: src/pmarlo/features/pairs.py:10,37).

Host copy of ``pmarlo_tpu/features/pairs.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def lagged_time_pairs(n_frames: int, lag: int) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform (i, i+lag) index pairs within one contiguous trajectory."""
    if lag < 1:
        raise ValueError(f"lag must be >= 1, got {lag}")
    if n_frames <= lag:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    idx = np.arange(n_frames - lag, dtype=np.int64)
    return idx, idx + lag


def make_training_pairs_from_trajectory(
    X: np.ndarray, lag: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(X_t, X_t+lag) arrays for one trajectory (reference pairs.py:37)."""
    i, j = lagged_time_pairs(X.shape[0], lag)
    return X[i], X[j]


def segment_lagged_pairs(
    segment_lengths: Sequence[int], lag: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Lagged pairs over concatenated segments without crossing boundaries.

    This is the segment-safety rule the reference enforces when shards are
    concatenated (analysis/counting.py:10, _estimation.py:121-145): a pair
    may only span frames of the same segment.
    """
    starts = np.cumsum([0] + list(segment_lengths))[:-1]
    lhs, rhs = [], []
    for start, length in zip(starts, segment_lengths):
        i, j = lagged_time_pairs(int(length), lag)
        lhs.append(i + start)
        rhs.append(j + start)
    if not lhs:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    return np.concatenate(lhs), np.concatenate(rhs)


def expected_pairs(segment_lengths: Sequence[int], lag: int) -> int:
    """Expected (t, t+lag) pair count (reference analysis/counting.py:10)."""
    return int(sum(max(0, int(n) - lag) for n in segment_lengths))


def diagnose_pairs(
    segment_lengths: Sequence[int], lag: int
) -> dict:
    """Usable-pair diagnostics (reference features/diagnostics.py:36)."""
    lengths = [int(n) for n in segment_lengths]
    usable = [max(0, n - lag) for n in lengths]
    too_short = [i for i, n in enumerate(lengths) if n <= lag]
    return {
        "lag": int(lag),
        "n_segments": len(lengths),
        "n_pairs": sum(usable),
        "pairs_per_segment": usable,
        "too_short_segments": too_short,
        "shortest_segment": min(lengths) if lengths else 0,
        "max_usable_lag": max((n - 1 for n in lengths), default=0),
    }


__all__ = [
    "lagged_time_pairs",
    "make_training_pairs_from_trajectory",
    "segment_lagged_pairs",
    "expected_pairs",
    "diagnose_pairs",
]
