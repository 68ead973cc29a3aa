"""MSM API: one-shot orchestration + macrostate helpers.

Reference: src/pmarlo/api/msm.py:103 analyze_msm, :455
build_msm_from_labels, :491 compute_macrostates, :519/:544/:572 macro
population/T/MFPT.

Host copy of ``pmarlo_tpu/api/msm.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..msm.enhanced import EnhancedMSM, run_complete_msm_analysis
from ..msm.estimation import MSMResult, build_msm
from ..msm.pcca import pcca_assignments
from ..utils.msm_utils import (
    macro_mfpt,
    macro_transition_matrix,
    stationary_distribution,
)


def analyze_msm(
    trajectories: Sequence,
    topology=None,
    *,
    temperature_K: float = 300.0,
    n_states: "int | str" = 50,
    lag_time: int = 10,
    feature_type: str = "phi_psi",
    use_tica: bool = False,
    output_dir: Optional["str | Path"] = None,
    seed: int = 0,
) -> EnhancedMSM:
    """Full-run orchestrator (reference api/msm.py:103)."""
    return run_complete_msm_analysis(
        trajectories, topology,
        temperature_K=temperature_K, n_states=n_states, lag_time=lag_time,
        feature_type=feature_type, use_tica=use_tica,
        output_dir=output_dir, seed=seed,
    )


def build_msm_from_labels(
    dtrajs: "np.ndarray | Sequence[np.ndarray]",
    lag: int,
    n_states: Optional[int] = None,
    *,
    reversible: bool = True,
) -> MSMResult:
    """(reference api/msm.py:455)."""
    return build_msm(dtrajs, lag, n_states, reversible=reversible)


def compute_macrostates(
    transition_matrix: np.ndarray,
    n_macrostates: int,
    pi: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(labels, memberships) (reference api/msm.py:491)."""
    return pcca_assignments(transition_matrix, n_macrostates, pi)


def macrostate_populations(
    pi: np.ndarray, assignments: np.ndarray
) -> np.ndarray:
    """(reference api/msm.py:519)."""
    pi = np.asarray(pi, dtype=np.float64)
    assignments = np.asarray(assignments)
    macros = np.unique(assignments)
    return np.asarray([pi[assignments == m].sum() for m in macros])


def macrostate_transition_matrix(
    T: np.ndarray, pi: np.ndarray, assignments: np.ndarray
) -> np.ndarray:
    """(reference api/msm.py:544)."""
    return macro_transition_matrix(T, pi, assignments)


def macrostate_mfpt(
    T: np.ndarray, pi: np.ndarray, assignments: np.ndarray, dt: float = 1.0
) -> np.ndarray:
    """(reference api/msm.py:572)."""
    return macro_mfpt(T, pi, assignments) * dt


__all__ = [
    "analyze_msm",
    "build_msm_from_labels",
    "compute_macrostates",
    "macrostate_populations",
    "macrostate_transition_matrix",
    "macrostate_mfpt",
]
