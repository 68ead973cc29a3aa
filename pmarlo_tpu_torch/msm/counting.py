"""Segment-safe transition counting as one device ``bincount``.

Port of ``pmarlo_tpu/msm/counting.py``: all segments are padded into one
(S, T) matrix with -1 sentinels, invalid labels (<0) and cross-segment
pairs are masked, and the count matrix is one ``torch.bincount`` over the
flattened (s_t * n + s_{t+tau}) indices where the JAX version used
``segment_sum``. Counts are exact integers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device


def counts_from_dtrajs(
    dtrajs: "np.ndarray | Sequence[np.ndarray]",
    lag: int,
    n_states: int,
    *,
    count_mode: str = "sliding",
) -> np.ndarray:
    """Count matrix C[i, j] = #(s_t = i, s_{t+lag} = j) over all segments.

    ``dtrajs`` is one int array or a list of them (one per segment/shard).
    Labels < 0 mark invalid frames and are excluded pairwise.
    ``count_mode``: "sliding" (every t) or "strided" (t in steps of lag).
    """
    if lag < 1:
        raise ValueError(f"lag must be >= 1, got {lag}")
    if count_mode not in ("sliding", "strided"):
        raise ValueError(f"count_mode must be sliding|strided, got {count_mode!r}")
    if isinstance(dtrajs, np.ndarray) and dtrajs.ndim == 1:
        dtrajs = [dtrajs]
    # pad all segments into one (S, T) matrix with -1 sentinels so counting
    # is ONE device call (a python loop over shards costs one dispatch
    # each — on latency-heavy links that dwarfed the math)
    segments = [np.asarray(d, dtype=np.int64) for d in dtrajs if len(d) > lag]
    if not segments:
        return np.zeros((n_states, n_states), dtype=np.float64)
    max_len = max(len(d) for d in segments)
    padded = np.full((len(segments), max_len), -1, dtype=np.int64)
    for i, d in enumerate(segments):
        padded[i, : len(d)] = d
    s = padded[:, :-lag]
    t = padded[:, lag:]
    if count_mode == "strided":
        s, t = s[:, ::lag], t[:, ::lag]
    valid = (s >= 0) & (t >= 0) & (s < n_states) & (t < n_states)
    return _count_pairs_device(
        s.reshape(-1), t.reshape(-1), valid.reshape(-1), n_states
    )


def _count_pairs_device(
    s: np.ndarray, t: np.ndarray, valid: np.ndarray, n_states: int
) -> np.ndarray:
    """Count (s, t) pairs where ``valid``: one ``bincount`` over the
    flattened ``s * n_states + t`` indices on the default device."""
    dev = default_device()
    flat = torch.as_tensor(s * n_states + t, device=dev)
    keep = torch.as_tensor(valid, device=dev)
    counts = torch.bincount(flat[keep], minlength=n_states * n_states)
    return counts.cpu().numpy().astype(np.float64).reshape(n_states, n_states)


def count_transitions(
    dtrajs: "np.ndarray | Sequence[np.ndarray]",
    lag: int,
    n_states: Optional[int] = None,
    *,
    count_mode: str = "sliding",
) -> Tuple[np.ndarray, int]:
    """Convenience wrapper inferring n_states; returns (counts, n_states)."""
    if isinstance(dtrajs, np.ndarray) and dtrajs.ndim == 1:
        dtrajs_list: List[np.ndarray] = [dtrajs]
    else:
        dtrajs_list = [np.asarray(d) for d in dtrajs]
    if n_states is None:
        maxi = max((int(d.max()) for d in dtrajs_list if d.size), default=-1)
        n_states = maxi + 1
    if n_states < 1:
        raise ValueError("cannot infer n_states from empty dtrajs")
    return counts_from_dtrajs(dtrajs_list, lag, n_states, count_mode=count_mode), n_states


def split_invalid_segments(dtraj: np.ndarray) -> List[np.ndarray]:
    """Split a label sequence at invalid (<0) frames into contiguous valid
    runs (reference _estimation.py:121-145 filtering semantics)."""
    d = np.asarray(dtraj, dtype=np.int64)
    valid = d >= 0
    if valid.all():
        return [d]
    out = []
    boundaries = np.flatnonzero(np.diff(valid.astype(np.int8)) != 0) + 1
    for chunk, chunk_valid in zip(
        np.split(d, boundaries), np.split(valid, boundaries)
    ):
        if chunk_valid.size and chunk_valid[0]:
            out.append(chunk)
    return out


__all__ = ["counts_from_dtrajs", "count_transitions", "split_invalid_segments"]
