"""EnhancedMSM: the end-to-end MSM analysis orchestrator.

Port of ``pmarlo_tpu/msm/enhanced.py``, a rebuild of the reference's
12-mixin monolith as one plain class over the functional stack (reference:
src/pmarlo/markov_state_model/_enhanced_impl.py:33-91 EnhancedMSM, :50
run_complete_msm_analysis; method surface contract at
enhanced_msm.py:19-85). Each stage delegates to the port's modules; the
class only holds state and wiring.

Two things differ from the JAX class:

- ``EnhancedMSM(..., device=None)`` resolves ``device`` through
  ``_device.default_device()`` (the card when there is one).
- ``compute_features`` featurizes each loaded trajectory on that device and
  keeps the (T, K) matrix on the host as ``np.float32`` in
  ``self.features``: one device-to-host copy a trajectory. TICA and the ITS
  posterior run on the same device; everything else works on host arrays.

The ``plot_*`` methods, and the plots ``run_complete_msm_analysis`` draws
after saving its npy, pickle and json files, import
``..visualization``, which the port does not have yet (ROADMAP A14): they
raise ``ModuleNotFoundError``.
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device
from ..features.base import TopologyInfo
from ..features.featurize import featurize_trajectory
from ..io.trajectory import TrajectoryReader
from ..utils.errors import EstimationError
from ..utils.json_io import write_json
from .ck import CKResult, ck_test, ck_test_macrostates
from .clustering import ClusteringResult, cluster_microstates
from .estimation import MSMResult, build_msm
from .free_energy import FESResult, generate_1d_pmf, generate_2d_fes
from .its import ITSResult, compute_implied_timescales
from .pcca import pcca_assignments
from .reduction import reduce_features

logger = logging.getLogger("pmarlo_tpu")


class EnhancedMSM:
    """Stateful MSM analysis over one or more trajectories.

    Trajectories can be npz paths (framework format), raw coordinate
    arrays (T, N, 3), or pre-computed feature matrices. Features, TICA and
    the ITS posterior are computed on ``device`` (``None``:
    ``_device.default_device()``).
    """

    def __init__(
        self,
        trajectories: Optional[Sequence] = None,
        topology: Optional[TopologyInfo] = None,
        temperature_K: float = 300.0,
        output_dir: Optional["str | Path"] = None,
        device=None,
    ):
        self.device = torch.device(device) if device is not None else default_device()
        self.topology = topology
        self.temperature_K = float(temperature_K)
        self.output_dir = Path(output_dir) if output_dir else None
        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)

        self.trajectories: List[np.ndarray] = []      # coordinate tensors
        self.features: List[np.ndarray] = []          # (T, K) per traj
        self.feature_info: Dict = {}
        self.dtrajs: List[np.ndarray] = []
        self.clustering: Optional[ClusteringResult] = None
        self.msm: Optional[MSMResult] = None
        self.its: Optional[ITSResult] = None
        self.fes: Optional[FESResult] = None
        self.ck: Optional[CKResult] = None
        self.state_table: Optional[List[Dict]] = None
        self.skipped_files: List[str] = []

        if trajectories is not None:
            self.load_trajectories(trajectories)

    # --- loading (reference _loading.py:21) ---------------------------------

    def load_trajectories(
        self,
        trajectories: Sequence,
        *,
        stride: int = 1,
        ignore_errors: bool = False,
    ) -> "EnhancedMSM":
        """Load npz paths / arrays with stride; error policy mirrors
        reference ignore_trajectory_errors (_loading.py:45)."""
        for item in trajectories:
            try:
                if isinstance(item, (str, Path)):
                    coords = TrajectoryReader(item).load()[::stride]
                else:
                    coords = np.asarray(item)[::stride]
                if coords.ndim == 2:  # feature matrix passed directly
                    self.features.append(coords.astype(np.float32))
                    continue
                if coords.ndim != 3 or coords.shape[0] == 0:
                    raise ValueError(f"bad trajectory shape {coords.shape}")
                self.trajectories.append(coords.astype(np.float32))
            except Exception as exc:
                if not ignore_errors:
                    raise
                self.skipped_files.append(f"{item}: {exc}")
                logger.warning("skipping trajectory %s: %s", item, exc)
        if not self.trajectories and not self.features:
            raise EstimationError("no trajectories loaded")
        return self

    # --- features (reference _features.py:23) --------------------------------

    def compute_features(
        self,
        feature_type: str = "phi_psi",
        *,
        use_tica: bool = False,
        tica_lag: int = 10,
        tica_components: int = 2,
    ) -> "EnhancedMSM":
        """Featurize all trajectories on ``self.device``. ``phi_psi`` is
        cos/sin-expanded like the reference (_features.py:131-142);
        optional in-place TICA. Each (T, K) matrix is kept on the host as
        ``np.float32``."""
        if not self.trajectories:
            if self.features:
                return self._maybe_tica(use_tica, tica_lag, tica_components)
            raise EstimationError("no coordinate trajectories to featurize")
        if self.topology is None:
            raise EstimationError("topology required for featurization")
        # features loaded DIRECTLY (2D matrices handed to
        # load_trajectories) must survive featurization of the
        # coordinate trajectories — replacing the list would silently
        # drop them from the analysis
        preloaded = list(self.features) if self.features else []
        feats = []
        for traj in self.trajectories:
            X, info = featurize_trajectory(
                traj, feature_type, self.topology,
                cos_sin_expand=(feature_type == "phi_psi"), device=self.device,
            )
            feats.append(X.detach().cpu().numpy().astype(np.float32, copy=False))
            self.feature_info = info
        if preloaded:
            k = feats[0].shape[1] if feats else None
            bad = [f.shape[1] for f in preloaded if k and f.shape[1] != k]
            if bad:
                raise EstimationError(
                    f"preloaded feature matrices have {bad} columns but "
                    f"featurization produced {k}; mixed widths cannot "
                    "share one MSM"
                )
        self.features = preloaded + feats
        return self._maybe_tica(use_tica, tica_lag, tica_components)

    def _maybe_tica(self, use_tica: bool, lag: int, n_components: int):
        if use_tica and self.features:
            self.features, model = reduce_features(
                self.features, "tica", lag=lag, n_components=n_components,
                device=self.device,
            )
            self.features = [np.asarray(f, dtype=np.float32) for f in self.features]
            k = self.features[0].shape[1]
            # the feature space CHANGED: columns are TICA components now,
            # and they are unbounded — stale torsion names/periodic flags
            # would wrap TIC values into [-pi, pi) in the FES and break
            # name-based CV lookup
            self.feature_info = {
                "columns": [f"TIC{i + 1}" for i in range(k)],
                "periodic": [False] * k,
                "source": dict(self.feature_info),
                "tica": {
                    "lag": lag,
                    "eigenvalues": model.eigenvalues.tolist(),
                },
            }
        return self

    # --- clustering (reference _clustering.py:18) ----------------------------

    def cluster_features(
        self, n_states: "int | str" = 50, *, seed: int = 0
    ) -> "EnhancedMSM":
        if not self.features:
            raise EstimationError("compute_features first")
        self.clustering = cluster_microstates(self.features, n_states, seed=seed,
                                              device=self.device)
        self.dtrajs = [d.astype(np.int64) for d in self.clustering.labels_per_traj]
        return self

    # --- estimation (reference _estimation.py:50) ----------------------------

    def build_msm(
        self,
        lag_time: "int | str" = 10,
        *,
        reversible: bool = True,
        count_mode: str = "sliding",
    ) -> "EnhancedMSM":
        """``lag_time="auto"`` selects the lag by the CK+ITS criterion
        (reference ck_its_selector.py:462)."""
        if not self.dtrajs:
            raise EstimationError("cluster_features first")
        if isinstance(lag_time, str):
            if lag_time != "auto":
                raise ValueError(f"lag_time must be int or 'auto', got {lag_time!r}")
            from .ck_its_selector import select_optimal_lag_ck_its

            selection = select_optimal_lag_ck_its(
                self.dtrajs, n_states=self.clustering.n_states
            )
            logger.info("auto lag selection: %s", selection.reason)
            lag_time = selection.selected_lag
        max_len = max(len(d) for d in self.dtrajs)
        lag = min(int(lag_time), max(max_len // 3, 1))  # lag capping
        if lag != lag_time:
            logger.warning("capping lag %d -> %d (trajectory length)", lag_time, lag)
        self.msm = build_msm(
            self.dtrajs, lag, self.clustering.n_states,
            reversible=reversible, count_mode=count_mode,
            temperature_K=self.temperature_K,
        )
        return self

    # --- validation ----------------------------------------------------------

    def compute_implied_timescales(
        self, lags: Optional[Sequence[int]] = None, *, n_samples: int = 100
    ) -> ITSResult:
        if not self.dtrajs:
            raise EstimationError("cluster_features first")
        self.its = compute_implied_timescales(
            self.dtrajs, lags,
            n_states=self.clustering.n_states, n_samples=n_samples,
            device=self.device,
        )
        return self.its

    def compute_ck_test(
        self, factors: Sequence[int] = (2, 3, 4), *, macro: Optional[int] = None
    ) -> CKResult:
        if self.msm is None:
            raise EstimationError("build_msm first")
        if macro:
            labels, _ = pcca_assignments(
                self.msm.restricted_T(), macro,
                self.msm.stationary_distribution[self.msm.active_states],
            )
            full = np.full(self.msm.n_states, -1, dtype=np.int64)
            full[self.msm.active_states] = labels
            self.ck = ck_test_macrostates(self.dtrajs, self.msm.lag, full, factors)
        else:
            self.ck = ck_test(self.dtrajs, self.msm.lag, factors,
                              n_states=self.msm.n_states)
        return self.ck

    # --- FES (reference _fes.py:67) -------------------------------------------

    def generate_free_energy_surface(
        self,
        cv1: "str | int" = 0,
        cv2: "str | int" = 1,
        *,
        bins: Optional[int] = 32,
        smoothing_mode: str = "auto",
    ) -> FESResult:
        """pi-reweighted FES over two feature columns (reference _fes.py:67:
        frame weights = pi(state)/count(state))."""
        if not self.features:
            raise EstimationError("compute_features first")
        X = np.concatenate(self.features, axis=0)
        c1 = self._cv_column(cv1)
        c2 = self._cv_column(cv2)
        weights = None
        if self.msm is not None and self.dtrajs:
            d = np.concatenate(self.dtrajs)
            pi = self.msm.stationary_distribution
            counts = np.bincount(d[d >= 0], minlength=self.msm.n_states).astype(float)
            counts[counts == 0] = 1.0
            w = np.where(d >= 0, pi[np.clip(d, 0, None)] / counts[np.clip(d, 0, None)], 0.0)
            weights = w
        periodic = (False, False)
        if isinstance(self.feature_info.get("periodic"), np.ndarray):
            per = self.feature_info["periodic"]
            periodic = (
                bool(per[c1]) if c1 < len(per) else False,
                bool(per[c2]) if c2 < len(per) else False,
            )
        names = self.feature_info.get("columns", [])
        self.fes = generate_2d_fes(
            X[:, c1], X[:, c2],
            temperature_K=self.temperature_K,
            bins=bins, weights=weights, periodic=periodic,
            smoothing_mode=smoothing_mode,
            cv_names=(
                names[c1] if c1 < len(names) else f"CV{c1}",
                names[c2] if c2 < len(names) else f"CV{c2}",
            ),
        )
        return self.fes

    def _cv_column(self, cv) -> int:
        if isinstance(cv, int):
            return cv
        names = self.feature_info.get("columns", [])
        if cv in names:
            return names.index(cv)
        if cv in ("CV1", "CV2"):
            return 0 if cv == "CV1" else 1
        raise KeyError(f"unknown CV {cv!r}; have {names[:8]}...")

    # --- states (reference _states.py:34) --------------------------------------

    def _bootstrap_free_energy_errors(
        self, n_boot: int = 200, seed: int = 0,
        temperature_K: "float | None" = None,
    ) -> np.ndarray:
        """Per-state dG standard errors from frame-bootstrap occupancies
        (reference _states.py:112). Defaults to the analysis temperature
        so the error bars share build_msm's kT."""
        from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL

        if not self.dtrajs or self.msm is None:
            raise EstimationError("build_msm first")
        if temperature_K is None:
            temperature_K = self.temperature_K
        assignments = np.concatenate(self.dtrajs)
        assignments = assignments[assignments >= 0]
        rng = np.random.default_rng(seed)
        n = assignments.size
        kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * temperature_K
        samples = np.empty((n_boot, self.msm.n_states))
        for i in range(n_boot):
            res = rng.choice(assignments, size=n, replace=True)
            samples[i] = np.bincount(res, minlength=self.msm.n_states)
        fe = -kT * np.log(np.clip(samples / n, 1e-12, None))
        fe[samples == 0] = np.nan
        return np.nanstd(fe, axis=0)

    def create_state_table(self, free_energy_errors: bool = False) -> List[Dict]:
        """Per-state populations, free energies, representative frames.
        ``free_energy_errors`` adds bootstrap dG_err per state."""
        if self.msm is None:
            raise EstimationError("build_msm first")
        d_all = np.concatenate(self.dtrajs)
        X_all = np.concatenate(self.features, axis=0)
        fe_err = (
            self._bootstrap_free_energy_errors()
            if free_energy_errors else None
        )
        table = []
        for s in range(self.msm.n_states):
            in_state = d_all == s
            count = int(in_state.sum())
            row = {
                "state": s,
                "count": count,
                "population": float(self.msm.stationary_distribution[s]),
                "free_energy": float(self.msm.free_energies[s])
                if self.msm.free_energies is not None else None,
                "active": bool(s in set(self.msm.active_states.tolist())),
            }
            if fe_err is not None:
                row["free_energy_err"] = (
                    float(fe_err[s]) if np.isfinite(fe_err[s]) else None
                )
            if count > 0 and self.clustering is not None:
                # representative = closest to centroid (reference _states.py:131)
                idx = np.where(in_state)[0]
                center = self.clustering.centers[s]
                dist = np.linalg.norm(X_all[idx] - center, axis=1)
                gframe = int(idx[np.argmin(dist)])
                traj_idx, local = self._global_to_local(gframe)
                row["representative"] = {"traj": traj_idx, "frame": local}
            table.append(row)
        self.state_table = table
        return table

    def _global_to_local(self, gframe: int) -> Tuple[int, int]:
        offset = 0
        for i, f in enumerate(self.features):
            if gframe < offset + len(f):
                return i, gframe - offset
            offset += len(f)
        raise IndexError(gframe)

    def extract_representative_structures(
        self, output_dir: Optional["str | Path"] = None
    ) -> List[Path]:
        """Write per-state representative PDBs (reference _states.py:60)."""
        from ..io.pdb import write_pdb

        if self.state_table is None:
            self.create_state_table()
        if not self.trajectories or self.topology is None:
            raise EstimationError("coordinate trajectories + topology required")
        out_dir = Path(output_dir or self.output_dir or ".") / "states"
        paths = []
        for row in self.state_table:
            rep = row.get("representative")
            if rep is None or not row["active"]:
                continue
            coords = self.trajectories[rep["traj"]][rep["frame"]]
            p = out_dir / f"state_{row['state']:04d}.pdb"
            write_pdb(
                p, coords,
                self.topology.atom_names,
                self.topology.residue_names,
                self.topology.residue_ids,
            )
            paths.append(p)
        return paths

    # --- export (reference _export.py:24) --------------------------------------

    def save_analysis_results(self, output_dir: Optional["str | Path"] = None) -> Path:
        out = Path(output_dir or self.output_dir or ".")
        out.mkdir(parents=True, exist_ok=True)
        if self.msm is not None:
            np.save(out / "transition_matrix.npy", self.msm.transition_matrix)
            np.save(out / "stationary_distribution.npy", self.msm.stationary_distribution)
            np.save(out / "counts.npy", self.msm.counts)
            (out / "msm_result.pkl").write_bytes(pickle.dumps(self.msm))
        if self.dtrajs:
            np.savez(out / "dtrajs.npz", **{f"dtraj_{i}": d for i, d in enumerate(self.dtrajs)})
        if self.fes is not None:
            self.fes.save(out / "fes.json")
        if self.its is not None:
            write_json(out / "its.json", self.its.to_dict())
        if self.ck is not None:
            write_json(out / "ck.json", self.ck.to_dict())
        if self.state_table is not None:
            write_json(out / "state_table.json", self.state_table)
        summary = {
            "temperature_K": self.temperature_K,
            "n_trajectories": len(self.features),
            "n_frames": int(sum(len(f) for f in self.features)),
            "n_states": self.clustering.n_states if self.clustering else None,
            "lag": self.msm.lag if self.msm else None,
            "skipped_files": self.skipped_files,
        }
        write_json(out / "analysis_summary.json", summary)
        return out

    # --- plots ------------------------------------------------------------------

    def plot_free_energy_surface(
        self, path: Optional["str | Path"] = None, *, interactive: bool = False
    ):
        """Static PNG by default; ``interactive=True`` writes a
        self-contained HTML page with hover F(cv1, cv2) readout (the
        reference's plotly mode, _plots.py:31,45)."""
        if interactive:
            from ..visualization.interactive import fes_html

            return fes_html(
                self.fes,
                path or (self.output_dir / "fes.html" if self.output_dir else None),
            )
        from ..visualization.plots import plot_fes

        return plot_fes(self.fes, path or (self.output_dir / "fes.png" if self.output_dir else None))

    def plot_implied_timescales(
        self, path: Optional["str | Path"] = None, *, interactive: bool = False
    ):
        if interactive:
            from ..visualization.interactive import its_html

            return its_html(
                self.its,
                path or (self.output_dir / "its.html" if self.output_dir else None),
            )
        from ..visualization.plots import plot_its

        return plot_its(self.its, path or (self.output_dir / "its.png" if self.output_dir else None))

    def plot_implied_rates(self, path: Optional["str | Path"] = None):
        """Implied rates 1/t_i vs lag (reference Protocol
        enhanced_msm.py:74-85 / _plots.py:188)."""
        from ..visualization.plots import plot_implied_rates

        if self.its is None:
            raise EstimationError("compute_implied_timescales first")
        return plot_implied_rates(
            self.its,
            path or (self.output_dir / "implied_rates.png"
                     if self.output_dir else None),
        )

    def plot_free_energy_profile(
        self, cv: "str | int" = 0, path: Optional["str | Path"] = None,
        *, bins: Optional[int] = None,
    ):
        """1D pi-reweighted PMF over one feature column (reference
        Protocol enhanced_msm.py:74-85 / _plots.py plot_free_energy_profile)."""
        from ..visualization.plots import plot_fes_1d

        if not self.features:
            raise EstimationError("compute_features first")
        X = np.concatenate(self.features, axis=0)
        c = self._cv_column(cv)
        weights = None
        if self.msm is not None and self.dtrajs:
            d = np.concatenate(self.dtrajs)
            pi = self.msm.stationary_distribution
            counts = np.bincount(
                d[d >= 0], minlength=self.msm.n_states
            ).astype(float)
            counts[counts == 0] = 1.0
            weights = np.where(
                d >= 0, pi[np.clip(d, 0, None)] / counts[np.clip(d, 0, None)],
                0.0,
            )
        periodic = False
        per = self.feature_info.get("periodic")
        if isinstance(per, np.ndarray) and c < len(per):
            periodic = bool(per[c])
        pmf = generate_1d_pmf(
            X[:, c], temperature_K=self.temperature_K, bins=bins,
            weights=weights, periodic=periodic,
        )
        return plot_fes_1d(
            pmf,
            path or (self.output_dir / "free_energy_profile.png"
                     if self.output_dir else None),
        )

    def plot_ck_test(self, path: Optional["str | Path"] = None):
        """Predicted-vs-estimated CK panel (reference Protocol
        enhanced_msm.py:74-85 / _plots.py plot_ck_test)."""
        from ..visualization.plots import plot_ck

        if self.ck is None:
            raise EstimationError("compute_ck_test first")
        return plot_ck(
            self.ck,
            path or (self.output_dir / "ck_test.png"
                     if self.output_dir else None),
        )


def run_complete_msm_analysis(
    trajectory_files: Sequence,
    topology: Optional[TopologyInfo] = None,
    *,
    temperature_K: float = 300.0,
    output_dir: Optional["str | Path"] = None,
    feature_type: str = "phi_psi",
    n_states: "int | str" = 50,
    lag_time: int = 10,
    use_tica: bool = False,
    stride: int = 1,
    compute_its: bool = True,
    compute_ck: bool = True,
    fes_pair: Tuple[int, int] = (0, 1),
    seed: int = 0,
    device=None,
) -> EnhancedMSM:
    """One-call pipeline (reference _enhanced_impl.py:50): load ->
    featurize -> cluster -> MSM -> ITS -> FES -> states -> save, on
    ``device`` (``None``: ``_device.default_device()``). With an
    ``output_dir`` the plots after the save raise ``ModuleNotFoundError``
    until the port has ``visualization`` (ROADMAP A14)."""
    msm = EnhancedMSM(
        topology=topology, temperature_K=temperature_K, output_dir=output_dir,
        device=device,
    )
    msm.load_trajectories(trajectory_files, stride=stride)
    msm.compute_features(feature_type, use_tica=use_tica)
    msm.cluster_features(n_states, seed=seed)
    msm.build_msm(lag_time)
    if compute_its:
        try:
            msm.compute_implied_timescales()
        except EstimationError as exc:
            logger.warning("ITS skipped: %s", exc)
    if compute_ck:
        try:
            msm.compute_ck_test()
        except EstimationError as exc:
            logger.warning("CK skipped: %s", exc)
    try:
        msm.generate_free_energy_surface(*fes_pair)
    except (EstimationError, ValueError, IndexError) as exc:
        logger.warning("FES skipped: %s", exc)
    msm.create_state_table()
    if output_dir is not None:
        msm.save_analysis_results()
        out = Path(output_dir)
        if msm.fes is not None:
            msm.plot_free_energy_surface(out / "fes.png")
        if msm.its is not None:
            msm.plot_implied_timescales(out / "its.png")
        if msm.ck is not None and msm.ck.predicted:
            from ..visualization.plots import plot_ck

            plot_ck(msm.ck, out / "ck.png")
    return msm


__all__ = ["EnhancedMSM", "run_complete_msm_analysis"]
