"""Dataset discretization: shards -> microstates -> counts -> T, with full
accounting.

Rebuild of src/pmarlo/analysis/discretize.py (:901 discretize_dataset, :22
MSMDiscretizationResult, :46 NoAssignmentsError): feature-schema validation
+ fingerprint, per-shard assignment, segment-safe pair accounting (expected
vs counted), low-count state pruning, count matrix + transition matrix +
diagonal mass.

A "dataset" here is a list of shard dicts (as returned by
``io.shards.read_shard``) or a plain list of (T, K) feature arrays.

Host copy of ``pmarlo_tpu/analysis/discretize.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..features.pairs import expected_pairs
from ..msm.clustering import assign_to_centers, cluster_microstates
from ..msm.counting import counts_from_dtrajs
from ..msm.estimation import estimate_transition_matrix
from ..utils.errors import NoAssignmentsError
from ..utils.msm_utils import ensure_connected_counts
from .validation import feature_schema_fingerprint, validate_features

Shard = Union[Dict, np.ndarray]


@dataclasses.dataclass
class MSMDiscretizationResult:
    """(reference discretize.py:22)."""

    centers: np.ndarray
    dtrajs: List[np.ndarray]
    counts: np.ndarray
    transition_matrix: np.ndarray
    stationary_distribution: np.ndarray
    active_states: np.ndarray
    lag: int
    n_states: int
    segment_lengths: List[int]
    expected_pair_count: int
    counted_pairs: int
    pruned_states: np.ndarray
    diag_mass: float
    schema_fingerprint: str
    artifacts: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "lag": self.lag,
            "n_states": self.n_states,
            "n_active": int(len(self.active_states)),
            "segment_lengths": self.segment_lengths,
            "expected_pairs": self.expected_pair_count,
            "counted_pairs": self.counted_pairs,
            "pruned_states": self.pruned_states.tolist(),
            "diag_mass": self.diag_mass,
            "schema_fingerprint": self.schema_fingerprint,
        }


def _extract_features(shard: Shard) -> Tuple[np.ndarray, int]:
    """(features, stride) from a shard dict or bare array."""
    if isinstance(shard, dict):
        if "features" not in shard:
            raise NoAssignmentsError("shard has no 'features' array")
        stride = int((shard.get("metadata") or {}).get("stride", 1))
        return np.asarray(shard["features"]), stride
    return np.asarray(shard), 1


class GridDiscretizer:
    """Uniform per-dimension grid mapped to OCCUPIED cells
    (reference discretize.py:517 _GridDiscretizer): bins_per_dim =
    round(target_states ** (1/d)); unseen cells map to -1 on
    transform."""

    def __init__(self, target_states: int):
        self.target_states = max(int(target_states), 1)
        self.edges: List[np.ndarray] = []
        self.mapping: dict = {}

    def fit(self, X: np.ndarray) -> "GridDiscretizer":
        X = np.asarray(X, np.float64)
        d = X.shape[1]
        bins = max(int(round(self.target_states ** (1.0 / d))), 1)
        self.edges = []
        for col in range(d):
            lo, hi = float(X[:, col].min()), float(X[:, col].max())
            if not (np.isfinite(lo) and np.isfinite(hi)):
                raise NoAssignmentsError("non-finite values in grid fit")
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
            self.edges.append(np.linspace(lo, hi, bins + 1))
        # vectorized occupied-cell numbering in first-seen order: a
        # per-frame Python loop with tuple/dict work turns multi-million-
        # frame datasets into a minutes-long assignment stage
        flat = self._flat_indices(X)
        uniq, first = np.unique(flat, return_index=True)
        order = np.argsort(first)                  # first-seen order
        state_of_uniq = np.empty(uniq.size, dtype=np.int64)
        state_of_uniq[order] = np.arange(uniq.size)
        self._uniq_sorted = uniq                   # np.unique -> sorted
        self._state_sorted = state_of_uniq
        dims = np.asarray([len(e) - 1 for e in self.edges])
        combos = np.stack(np.unravel_index(uniq, dims), axis=1)
        self.mapping = {
            tuple(int(c) for c in combo): int(s)
            for combo, s in zip(combos, state_of_uniq)
        }
        return self

    def _flat_indices(self, X: np.ndarray) -> np.ndarray:
        idx = [
            np.clip(np.digitize(X[:, d_], e) - 1, 0, len(e) - 2)
            for d_, e in enumerate(self.edges)
        ]
        dims = [len(e) - 1 for e in self.edges]
        return np.ravel_multi_index(idx, dims)

    def transform(self, X: np.ndarray) -> np.ndarray:
        flat = self._flat_indices(np.asarray(X, np.float64))
        pos = np.searchsorted(self._uniq_sorted, flat)
        pos_c = np.clip(pos, 0, max(self._uniq_sorted.size - 1, 0))
        valid = (
            (self._uniq_sorted[pos_c] == flat)
            if self._uniq_sorted.size else np.zeros(flat.size, bool)
        )
        return np.where(valid, self._state_sorted[pos_c], -1).astype(np.int64)

    @property
    def n_states(self) -> int:
        return len(self.mapping)

    @property
    def centers(self) -> np.ndarray:
        cents = np.empty((self.n_states, len(self.edges)))
        for key, s in self.mapping.items():
            for d_, (e, k_) in enumerate(zip(self.edges, key)):
                cents[s, d_] = 0.5 * (e[k_] + e[k_ + 1])
        return cents


def discretize_dataset(
    dataset: Sequence[Shard],
    *,
    n_states: "int | str" = 50,
    lag: int = 10,
    min_state_count: int = 0,
    seed: int = 0,
    columns: Optional[Sequence[str]] = None,
    reversible: bool = True,
    method: str = "kmeans",
) -> MSMDiscretizationResult:
    """Discretize a shard dataset into an MSM with full pair accounting.

    Steps (mirroring reference discretize.py:901): validate every shard's
    feature matrix and schema consistency -> k-means (or uniform grid,
    ``method="grid"``) over the pooled features -> per-shard assignment
    (segments never concatenate across shards) -> expected vs counted
    pair check -> optional low-count state pruning (labels -> -1) ->
    counts -> connected set -> T, pi.
    """
    if not dataset:
        raise NoAssignmentsError("empty dataset")
    feats: List[np.ndarray] = []
    strides: List[int] = []
    k_ref: Optional[int] = None
    for i, shard in enumerate(dataset):
        X, stride = _extract_features(shard)
        X = validate_features(X, name=f"shard[{i}]")
        if k_ref is None:
            k_ref = X.shape[1]
        elif X.shape[1] != k_ref:
            raise NoAssignmentsError(
                f"shard[{i}] has {X.shape[1]} features, expected {k_ref} "
                "(mixed feature schemas)"
            )
        feats.append(X.astype(np.float32))
        strides.append(stride)
    fingerprint = feature_schema_fingerprint(
        columns or [f"f{i}" for i in range(k_ref)], k_ref
    )

    if method == "grid":
        if not isinstance(n_states, (int, np.integer)):
            raise NoAssignmentsError("grid method needs integer n_states")
        grid = GridDiscretizer(int(n_states)).fit(
            np.concatenate(feats, axis=0)
        )
        k = grid.n_states
        dtrajs = [grid.transform(X) for X in feats]
        centers = grid.centers
        silhouette = None
    elif method == "kmeans":
        clustering = cluster_microstates(feats, n_states, seed=seed)
        k = clustering.n_states
        dtrajs = [d.astype(np.int64) for d in clustering.labels_per_traj]
        centers = clustering.centers
        silhouette = clustering.silhouette
    else:
        raise NoAssignmentsError(f"unknown discretization method {method!r}")

    # low-count state pruning: mark assignments in starved states invalid
    pooled = np.concatenate(dtrajs)
    state_counts = np.bincount(pooled[pooled >= 0], minlength=k)
    pruned = np.where(state_counts < min_state_count)[0] if min_state_count > 0 \
        else np.zeros(0, dtype=np.int64)
    if pruned.size:
        prune_set = set(pruned.tolist())
        dtrajs = [
            np.where(np.isin(d, list(prune_set)), -1, d) for d in dtrajs
        ]

    seg_lengths = [len(d) for d in dtrajs]
    exp_pairs = expected_pairs(seg_lengths, lag)
    C = counts_from_dtrajs(dtrajs, lag, k)
    counted = int(C.sum())
    if counted == 0:
        raise NoAssignmentsError(
            f"no (t, t+{lag}) pairs counted over {len(dtrajs)} shards "
            f"(expected {exp_pairs}; segments too short or all pruned)"
        )

    C_active, active = ensure_connected_counts(C)
    T_active, pi_active = estimate_transition_matrix(C_active, reversible=reversible)
    T = np.eye(k)
    T[np.ix_(active, active)] = T_active
    pi = np.zeros(k)
    pi[active] = pi_active
    diag_mass = float(np.trace(C) / max(C.sum(), 1.0))

    return MSMDiscretizationResult(
        centers=centers,
        dtrajs=dtrajs,
        counts=C,
        transition_matrix=T,
        stationary_distribution=pi,
        active_states=active,
        lag=int(lag),
        n_states=k,
        segment_lengths=seg_lengths,
        expected_pair_count=exp_pairs,
        counted_pairs=counted,
        pruned_states=pruned,
        diag_mass=diag_mass,
        schema_fingerprint=fingerprint,
        artifacts={"strides": strides, "silhouette": silhouette,
                   "method": method},
    )


def assign_dataset(
    dataset: Sequence[Shard], centers: np.ndarray
) -> List[np.ndarray]:
    """Assign shards to existing centers (for val splits / new data)."""
    out = []
    for shard in dataset:
        X, _ = _extract_features(shard)
        out.append(assign_to_centers(X, centers).astype(np.int64))
    return out


__all__ = ["MSMDiscretizationResult", "GridDiscretizer",
           "discretize_dataset", "assign_dataset", "NoAssignmentsError"]
