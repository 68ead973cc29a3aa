"""K-means microstate clustering in plain PyTorch.

Port of ``pmarlo_tpu/msm/clustering.py``: k-means++ seeding, Lloyd
iterations on the matmul distance identity, best of ``n_init`` trials.
Trials run in a Python loop in place of ``vmap``, and k-means++ draws from a
``torch.Generator`` in place of a JAX key: the same seed gives different
centers than the JAX package, while the same initial centers give the same
Lloyd result.

Functions that take no ``device`` run on ``_device.default_device()``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device


@dataclasses.dataclass
class ClusteringResult:
    """Reference-parity result container (clustering.py:43)."""

    centers: np.ndarray          # (k, d)
    labels: np.ndarray           # (T,) concatenated
    inertia: float
    n_states: int
    labels_per_traj: Optional[List[np.ndarray]] = None
    silhouette: Optional[float] = None

    def to_dict(self):
        return {
            "centers": self.centers.tolist(),
            "n_states": self.n_states,
            "inertia": self.inertia,
            "silhouette": self.silhouette,
        }


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(T, d), (k, d) -> (T, k) squared distances via the matmul identity."""
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (c * c).sum(1)[None, :]
    return torch.clamp(x2 + c2 - 2.0 * (x @ c.T), min=0.0)


def _kmeans_pp_init(generator: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding: the first center uniform, each next one drawn with
    probability proportional to D^2 (uniform when all D^2 are 0)."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first[0]]
    min_d2 = ((x - centers[0][None, :]) ** 2).sum(1)
    for i in range(1, k):
        total = min_d2.sum()
        probs = torch.where(
            total > 0.0, min_d2 / torch.clamp(total, min=1e-30),
            torch.full_like(min_d2, 1.0 / n),
        )
        idx = torch.multinomial(probs, 1, generator=generator)[0]
        centers[i] = x[idx]
        min_d2 = torch.minimum(min_d2, ((x - centers[i][None, :]) ** 2).sum(1))
    return centers


def _lloyd(x: torch.Tensor, centers: torch.Tensor, n_iter: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_iter`` Lloyd updates (empty clusters keep their center).
    Returns (centers, labels, inertia)."""
    k, d = centers.shape
    c = centers
    for _ in range(n_iter):
        labels = torch.argmin(_pairwise_sq_dists(x, c), dim=1)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        sums = torch.zeros((k, d), dtype=x.dtype, device=x.device).index_add_(0, labels, x)
        c = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], c
        )
    d2 = _pairwise_sq_dists(x, c)
    labels = torch.argmin(d2, dim=1)
    inertia = d2.min(dim=1).values.sum()
    return c, labels, inertia


def _kmeans_fused(x: torch.Tensor, generator: torch.Generator, k: int,
                  n_iter: int, n_trials: int):
    """k-means++ init + Lloyd, best of ``n_trials`` by inertia."""
    best = None
    for _ in range(n_trials):
        centers, _, inertia = _lloyd(x, _kmeans_pp_init(generator, x, k), n_iter)
        if best is None or inertia < best[1]:
            best = (centers, inertia)
    centers, inertia = best
    labels = torch.argmin(_pairwise_sq_dists(x, centers), dim=1)
    return centers, labels, inertia


def kmeans(
    x,
    n_states: int,
    *,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    n_iter: int = 50,
    n_init: int = 1,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Device k-means. Returns (centers, labels, inertia) as host arrays."""
    device = torch.device(device) if device is not None else default_device()
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    if x.ndim != 2:
        raise ValueError(f"expected (T, d) features, got {tuple(x.shape)}")
    if n_states < 2:
        raise ValueError("n_states must be >= 2")
    if x.shape[0] < n_states:
        raise ValueError(f"{x.shape[0]} samples < {n_states} clusters")
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
    centers, labels, inertia = _kmeans_fused(
        x, generator, int(n_states), int(n_iter), max(int(n_init), 1)
    )
    return centers.cpu().numpy(), labels.cpu().numpy(), float(inertia)


def silhouette_score(x, labels, n_states: int, max_samples: int = 2048,
                     seed: int = 0) -> float:
    """Mean silhouette on a subsample (sklearn conventions: singletons
    score 0)."""
    x = np.asarray(x)
    labels = np.asarray(labels)
    if len(np.unique(labels)) < 2:
        return -1.0
    if x.shape[0] > max_samples:
        rng = np.random.default_rng(seed)
        idx = rng.choice(x.shape[0], max_samples, replace=False)
        xs, ls = x[idx], labels[idx]
    else:
        xs, ls = x, labels
    xs_t = torch.as_tensor(xs, dtype=torch.float32, device=default_device())
    d = torch.sqrt(_pairwise_sq_dists(xs_t, xs_t) + 1e-12).cpu().numpy()
    n = xs.shape[0]
    clusters = np.unique(ls)
    onehot = (ls[:, None] == clusters[None, :]).astype(np.float64)
    counts = onehot.sum(axis=0)
    sums = d @ onehot
    own = onehot.astype(bool)
    own_counts = counts[np.argmax(own, axis=1)]
    a = np.where(
        own_counts > 1,
        (sums[own].reshape(n)) / np.maximum(own_counts - 1, 1),
        0.0,
    )
    mean_to = sums / np.maximum(counts[None, :], 1)
    mean_to[own] = np.inf
    b = mean_to.min(axis=1)
    denom = np.maximum(a, b)
    sil = np.where((denom > 0) & np.isfinite(b), (b - a) / denom, 0.0)
    sil = np.where(own_counts <= 1, 0.0, sil)
    return float(sil.mean())


def _auto_select_n_states(x, k_range: Sequence[int], seed: int, n_iter: int,
                          device=None) -> Tuple[int, float]:
    """Silhouette-maximizing k over the candidate range."""
    best_k, best_s = None, -np.inf
    for k in k_range:
        if x.shape[0] < k:
            continue
        _, labels, _ = kmeans(x, k, seed=seed, n_iter=n_iter, device=device)
        s = silhouette_score(x, labels, k, seed=seed)
        if s > best_s:
            best_k, best_s = k, s
    if best_k is None:
        raise ValueError("no candidate k feasible for dataset size")
    return best_k, best_s


def cluster_microstates(
    features: "np.ndarray | Sequence[np.ndarray]",
    n_states: "int | str" = 50,
    *,
    seed: int = 0,
    n_iter: int = 50,
    n_init: int = 2,
    auto_range: Sequence[int] = range(4, 21),
    device=None,
) -> ClusteringResult:
    """Cluster one or many feature trajectories into microstates
    (``n_states="auto"`` picks k by silhouette). Labels are split back
    per trajectory. k-means runs on ``device`` (``None``:
    ``_device.default_device()``)."""
    if isinstance(features, (list, tuple)):
        lengths = [np.asarray(f).shape[0] for f in features]
        X = np.concatenate([np.asarray(f) for f in features], axis=0)
    else:
        X = np.asarray(features)
        lengths = [X.shape[0]]

    silhouette = None
    if isinstance(n_states, str):
        if n_states != "auto":
            raise ValueError(f"n_states must be int or 'auto', got {n_states!r}")
        k, silhouette = _auto_select_n_states(X, auto_range, seed, n_iter, device)
    else:
        k = int(n_states)

    centers, labels, inertia = kmeans(X, k, seed=seed, n_iter=n_iter, n_init=n_init,
                                      device=device)
    splits = np.cumsum(lengths)[:-1]
    per_traj = [np.asarray(a) for a in np.split(labels, splits)]
    return ClusteringResult(
        centers=centers, labels=labels, inertia=inertia, n_states=k,
        labels_per_traj=per_traj, silhouette=silhouette,
    )


def assign_to_centers(features, centers) -> np.ndarray:
    """Nearest-center assignment for new data."""
    dev = default_device()
    x = torch.as_tensor(np.asarray(features), dtype=torch.float32, device=dev)
    c = torch.as_tensor(np.asarray(centers), dtype=torch.float32, device=dev)
    return torch.argmin(_pairwise_sq_dists(x, c), dim=1).cpu().numpy()


__all__ = [
    "ClusteringResult", "kmeans", "cluster_microstates", "assign_to_centers",
    "silhouette_score",
]
