"""Bootstrap uncertainty for TPT observables
(reference: src/pmarlo/conformations/uncertainty.py:15,31 — trajectory
resampling -> MSM rebuild -> TPT observable CIs; hyperparameter ensembles).

Host copy of ``pmarlo_tpu/conformations/uncertainty.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..msm.estimation import build_msm
from ..msm.tpt import reactive_flux
from ..utils.errors import EstimationError
from .results import UncertaintyResult


@dataclasses.dataclass
class UncertaintyQuantifier:
    n_bootstrap: int = 50
    ci_level: float = 0.95
    seed: int = 0

    def bootstrap_tpt(
        self,
        dtrajs: Sequence[np.ndarray],
        lag: int,
        n_states: int,
        source: Sequence[int],
        sink: Sequence[int],
    ) -> UncertaintyResult:
        """Resample trajectories with replacement, rebuild the MSM, rerun
        TPT, and report percentile CIs of rate/MFPT/total flux."""
        rng = np.random.default_rng(self.seed)
        dtrajs = [np.asarray(d) for d in dtrajs]
        observables: Dict[str, List[float]] = {"rate": [], "mfpt": [], "total_flux": []}
        src_set, snk_set = set(map(int, source)), set(map(int, sink))
        for _ in range(self.n_bootstrap):
            idx = rng.integers(0, len(dtrajs), len(dtrajs))
            sample = [dtrajs[i] for i in idx]
            try:
                msm = build_msm(sample, lag, n_states)
                active = set(msm.active_states.tolist())
                if not (src_set <= active and snk_set <= active):
                    continue
                # map endpoint indices into the restricted space
                remap = {s: i for i, s in enumerate(msm.active_states.tolist())}
                A = [remap[s] for s in src_set]
                B = [remap[s] for s in snk_set]
                t = reactive_flux(
                    msm.restricted_T(), A, B,
                    pi=msm.stationary_distribution[msm.active_states],
                    n_pathways=0,
                )
                if np.isfinite(t.rate):
                    observables["rate"].append(t.rate)
                    observables["mfpt"].append(t.mfpt)
                    observables["total_flux"].append(t.total_flux)
            except (EstimationError, np.linalg.LinAlgError):
                continue
        if not observables["rate"]:
            raise EstimationError(
                "no bootstrap sample produced a connected MSM containing the endpoints"
            )
        lo_q = (1 - self.ci_level) / 2
        means, cis = {}, {}
        for key, values in observables.items():
            arr = np.asarray(values)
            means[key] = float(arr.mean())
            cis[key] = (
                float(np.quantile(arr, lo_q)),
                float(np.quantile(arr, 1 - lo_q)),
            )
        return UncertaintyResult(
            observable_means=means,
            observable_cis=cis,
            n_bootstrap=len(observables["rate"]),
            ci_level=self.ci_level,
        )

    def hyperparameter_ensemble(
        self,
        dtrajs: Sequence[np.ndarray],
        lags: Sequence[int],
        n_states: int,
        source: Sequence[int],
        sink: Sequence[int],
        *,
        features: Optional[Sequence[np.ndarray]] = None,
        n_clusters_grid: Optional[Sequence[int]] = None,
        seeds: Sequence[int] = (0,),
    ) -> Dict:
        """TPT observables across an estimator-hyperparameter grid
        (reference uncertainty.py:263 hyperparameter_ensemble +
        :318 ensemble_observable_statistics).

        The grid is lag x n_clusters x clustering-seed. Reclustering
        (``n_clusters_grid``) requires ``features`` (per-trajectory
        feature matrices on the SAME frames as ``dtrajs``); endpoint sets
        are re-detected per reclustering via the eigenmode split, since
        microstate indices do not survive a reclustering. Without
        ``features`` the grid reduces to lag x seed over the given
        ``dtrajs``. Returns ``{"members": [...], "pooled": {...}}`` where
        pooled carries mean/std/ci per observable across the ensemble —
        the reference's hyperparameter-sensitivity report."""
        members: List[Dict] = []
        pooled: Dict[str, List[float]] = {"rate": [], "mfpt": [], "total_flux": []}
        cluster_options: List[Optional[int]] = (
            list(n_clusters_grid) if n_clusters_grid else [None]
        )
        for n_clusters in cluster_options:
            for seed in seeds:
                if n_clusters is None:
                    grid_dtrajs = [np.asarray(d) for d in dtrajs]
                    grid_n_states = n_states
                    grid_src, grid_snk = list(source), list(sink)
                else:
                    if features is None:
                        raise EstimationError(
                            "n_clusters_grid requires features for reclustering"
                        )
                    from ..msm.clustering import cluster_microstates

                    res = cluster_microstates(
                        [np.asarray(f) for f in features],
                        n_states=int(n_clusters), seed=int(seed),
                    )
                    grid_dtrajs = [
                        np.asarray(d) for d in (res.labels_per_traj or [res.labels])
                    ]
                    grid_n_states = int(n_clusters)
                    grid_src = grid_snk = None  # re-detect below
                for lag in lags:
                    try:
                        msm = build_msm(list(grid_dtrajs), int(lag), grid_n_states)
                        T_r = msm.restricted_T()
                        pi_r = msm.stationary_distribution[msm.active_states]
                        if grid_src is None:
                            from .state_detection import StateDetector

                            A, B = StateDetector().detect_from_eigenmode(T_r, pi_r)
                            A, B = list(A), list(B)
                        else:
                            remap = {
                                s: i for i, s in enumerate(msm.active_states.tolist())
                            }
                            if not all(int(s) in remap
                                       for s in grid_src + grid_snk):
                                continue
                            A = [remap[int(s)] for s in grid_src]
                            B = [remap[int(s)] for s in grid_snk]
                        t = reactive_flux(T_r, A, B, pi=pi_r, n_pathways=0)
                        if not np.isfinite(t.rate):
                            continue
                        obs = {"rate": t.rate, "mfpt": t.mfpt,
                               "total_flux": t.total_flux}
                        members.append({
                            "params": {"lag": int(lag),
                                       "n_clusters": n_clusters,
                                       "seed": int(seed)},
                            **obs,
                        })
                        for k, v in obs.items():
                            pooled[k].append(float(v))
                    except (EstimationError, np.linalg.LinAlgError):
                        continue
        lo_q = (1 - self.ci_level) / 2
        stats: Dict[str, Dict[str, float]] = {}
        for k, vals in pooled.items():
            if not vals:
                continue
            arr = np.asarray(vals)
            stats[k] = {
                "mean": float(arr.mean()),
                "std": float(arr.std()),
                "ci_lower": float(np.quantile(arr, lo_q)),
                "ci_upper": float(np.quantile(arr, 1 - lo_q)),
                "n_samples": int(arr.size),
            }
        return {"members": members, "pooled": stats}


__all__ = ["UncertaintyQuantifier"]
