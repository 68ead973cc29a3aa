"""Shard-parallel reductions: counts, covariances, histograms over a mesh.

Port of ``pmarlo_tpu/parallel/reductions.py``. As JAX's caller does, every
rank is given the global ``(S, T[, K])`` array; rank r takes rows
``[r S / n, (r + 1) S / n)`` (``S`` must divide), computes its partial sums
on its device, and one ``all_reduce`` SUM joins them. Every rank returns
the same float64 host numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .mesh import all_reduce_sum, check_mesh, mesh_block, rank_device


def _local_rows(a, mesh, axis: str, dtype) -> torch.Tensor:
    check_mesh(mesh, axis)
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
    lo, hi = mesh_block(int(t.shape[0]), mesh, "the shard axis")
    return t[lo:hi].to(device=rank_device(mesh), dtype=dtype)


def sharded_transition_counts(
    dtrajs,                    # (S, T) padded label matrix, -1 = invalid
    lag: int,
    n_states: int,
    mesh,
    axis: str = "shard",
) -> np.ndarray:
    """Count matrix over the shard rows: each rank counts its rows
    (segment-safe: rows never mix), one ``all_reduce`` merges the counts."""
    local = _local_rows(dtrajs, mesh, axis, torch.int64)
    s, t = local[:, :-lag], local[:, lag:]
    valid = (s >= 0) & (t >= 0) & (s < n_states) & (t < n_states)
    flat = (s * n_states + t)[valid]
    c = torch.bincount(flat, minlength=n_states * n_states).to(torch.float64)
    c = all_reduce_sum(c, mesh)
    return c.reshape(n_states, n_states).cpu().numpy()


def sharded_covariance_moments(
    X,                          # (S, T, K) feature tensor
    lag: int,
    mesh,
    axis: str = "shard",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Streaming TICA moments over a mesh: each rank's float32 sums of
    (C00, C0t, Ctt, s0, st, n) in one buffer, one ``all_reduce``, then the
    float64 centring JAX does on the host."""
    local = _local_rows(X, mesh, axis, torch.float32)
    K = local.shape[-1]
    X0 = local[:, :-lag, :].reshape(-1, K)
    Xt = local[:, lag:, :].reshape(-1, K)
    parts = (X0.T @ X0, X0.T @ Xt, Xt.T @ Xt, X0.sum(0), Xt.sum(0),
             torch.full((1,), float(X0.shape[0]), device=local.device))
    buf = all_reduce_sum(torch.cat([p.reshape(-1).double() for p in parts]), mesh)
    buf = buf.cpu().numpy()
    kk = K * K
    C00, C0t, Ctt = (buf[i * kk:(i + 1) * kk].reshape(K, K) for i in range(3))
    s0, st = buf[3 * kk:3 * kk + K], buf[3 * kk + K:3 * kk + 2 * K]
    n = int(round(buf[-1]))
    mean0, meant = s0 / n, st / n
    C00 = C00 / n - np.outer(mean0, mean0)
    C0t = C0t / n - np.outer(mean0, meant)
    Ctt = Ctt / n - np.outer(meant, meant)
    return C00, C0t, Ctt, mean0, meant, n


def sharded_histogram(
    values,                     # (S, T) scalar series
    edges: np.ndarray,
    mesh,
    axis: str = "shard",
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """1D histogram accumulated per rank then merged by one ``all_reduce``:
    JAX's bins (float32 edges, ``searchsorted`` left, clipped to the end
    bins) and its range mask ``edges[0] <= v <= edges[-1]``."""
    flat = _local_rows(values, mesh, axis, torch.float32).reshape(-1)
    e = torch.as_tensor(np.asarray(edges, np.float32), device=flat.device)
    n_bins = len(edges) - 1
    idx = torch.clamp(torch.bucketize(flat, e) - 1, 0, n_bins - 1)
    in_range = (flat >= e[0]) & (flat <= e[-1])
    w = (torch.ones_like(flat) if weights is None
         else _local_rows(weights, mesh, axis, torch.float32).reshape(-1))
    w = torch.where(in_range, w, torch.zeros_like(w)).double()
    h = torch.zeros(n_bins, dtype=torch.float64, device=flat.device).index_add_(0, idx, w)
    return all_reduce_sum(h, mesh).cpu().numpy()


__all__ = [
    "sharded_transition_counts",
    "sharded_covariance_moments",
    "sharded_histogram",
]
