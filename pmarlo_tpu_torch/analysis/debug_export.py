"""Pre-build MSM diagnostics: counts, SCC, dwell times, occupancy tails.

Reference: src/pmarlo/analysis/debug_export.py:50 compute_analysis_debug /
:27 AnalysisDebugData — counts, SCC decomposition, zero rows, dwell times,
occupancy tail, isolated states, diagonal mass; JSON export.

Host copy of ``pmarlo_tpu/analysis/debug_export.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..msm.counting import counts_from_dtrajs
from ..utils.json_io import write_json
from ..utils.scc import analyse_scc


@dataclasses.dataclass
class AnalysisDebugData:
    """(reference debug_export.py:27)."""

    n_states: int
    lag: int
    total_counts: float
    diag_mass: float
    zero_rows: List[int]
    isolated_states: List[int]
    scc: Dict
    occupancy: List[float]
    occupancy_tail: List[int]        # least-occupied 10%
    dwell_time_mean: Dict[int, float]
    segment_lengths: List[int]

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def save(self, path: "str | Path") -> Path:
        return write_json(path, self.to_dict())


def _dwell_times(dtrajs: Sequence[np.ndarray], n_states: int) -> Dict[int, float]:
    """Mean consecutive-run length per state."""
    totals = np.zeros(n_states)
    runs = np.zeros(n_states)
    for d in dtrajs:
        d = np.asarray(d)
        if d.size == 0:
            continue
        change = np.flatnonzero(np.diff(d) != 0) + 1
        for seg in np.split(d, change):
            s = seg[0]
            if s >= 0:
                totals[s] += len(seg)
                runs[s] += 1
    return {
        int(s): float(totals[s] / runs[s]) for s in range(n_states) if runs[s] > 0
    }


def compute_analysis_debug(
    dtrajs: Sequence[np.ndarray],
    lag: int,
    n_states: Optional[int] = None,
    output_json: Optional["str | Path"] = None,
) -> AnalysisDebugData:
    """(reference debug_export.py:50)."""
    dtrajs = [np.asarray(d, dtype=np.int64) for d in dtrajs]
    if n_states is None:
        n_states = max((int(d.max()) for d in dtrajs if d.size), default=-1) + 1
    C = counts_from_dtrajs(dtrajs, lag, n_states)
    occupancy = np.zeros(n_states)
    for d in dtrajs:
        occupancy += np.bincount(d[d >= 0], minlength=n_states)
    total = max(occupancy.sum(), 1.0)
    occ_frac = occupancy / total

    row_sums = C.sum(axis=1)
    zero_rows = np.where(row_sums == 0)[0].tolist()
    isolated = np.where((row_sums == 0) & (C.sum(axis=0) == 0) & (occupancy > 0))[0].tolist()
    tail_n = max(n_states // 10, 1)
    occupancy_tail = np.argsort(occ_frac)[:tail_n].tolist()

    data = AnalysisDebugData(
        n_states=int(n_states),
        lag=int(lag),
        total_counts=float(C.sum()),
        diag_mass=float(np.trace(C) / max(C.sum(), 1.0)),
        zero_rows=[int(z) for z in zero_rows],
        isolated_states=[int(i) for i in isolated],
        scc=analyse_scc(C),
        occupancy=occ_frac.tolist(),
        occupancy_tail=[int(i) for i in occupancy_tail],
        dwell_time_mean=_dwell_times(dtrajs, n_states),
        segment_lengths=[len(d) for d in dtrajs],
    )
    if output_json is not None:
        data.save(output_json)
    return data


def export_analysis_debug(
    dtrajs: Sequence[np.ndarray],
    lag: int,
    output_dir: "str | Path",
    *,
    n_states: Optional[int] = None,
    features: "Sequence[np.ndarray] | None" = None,
    fes=None,
    extra_metadata: Optional[Dict] = None,
) -> "Path":
    """Directory-form debug bundle (reference debug_export.py:204
    export_analysis_debug): core arrays as npz + summary.json, plus
    optional feature stats and a FES export."""
    import json

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    data = compute_analysis_debug(dtrajs, lag, n_states=n_states)
    C = counts_from_dtrajs(
        [np.asarray(d, np.int64) for d in dtrajs], lag, data.n_states
    )
    arrays = {
        "counts": C,
        "occupancy": np.asarray(data.occupancy),
    }
    for i, d in enumerate(dtrajs):
        arrays[f"dtraj_{i:04d}"] = np.asarray(d, np.int64)
    np.savez_compressed(out / "core_arrays.npz", **arrays)

    summary = data.to_dict()
    if features is not None:
        pooled = np.concatenate([np.asarray(f) for f in features], axis=0)
        summary["feature_stats"] = {
            "n_frames": int(pooled.shape[0]),
            "n_features": int(pooled.shape[1]),
            "mean": pooled.mean(axis=0).tolist(),
            "std": pooled.std(axis=0).tolist(),
            "nonfinite_fraction": float((~np.isfinite(pooled)).mean()),
        }
    if fes is not None:
        fes_path = out / "fes.json"
        try:
            fes.save_json(fes_path)
        except AttributeError:
            fes_path.write_text(json.dumps(fes.to_dict()))
        summary["fes_export"] = fes_path.name
    if extra_metadata:
        summary["metadata"] = extra_metadata
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    return out


__all__ = [
    "AnalysisDebugData",
    "compute_analysis_debug",
    "export_analysis_debug",
]
