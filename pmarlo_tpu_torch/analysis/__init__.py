"""Dataset-level analysis over shard collections: discretization with
schema validation and pair accounting, whitening-aware MSM preparation, CV
projection, the KDE FES, the pre-build debug export and autocorrelation
diagnostics.

Port of ``pmarlo_tpu/analysis``; exports what ``pmarlo_tpu.analysis``
exports.
"""

from .discretize import (
    GridDiscretizer,
    MSMDiscretizationResult,
    discretize_dataset,
)
from .msm import prepare_msm_discretization, ensure_msm_inputs_whitened
from .project_cv import apply_whitening_from_metadata
from .counting import expected_pairs
from .validation import validate_features
from .debug_export import (
    AnalysisDebugData,
    compute_analysis_debug,
    export_analysis_debug,
)
from .diagnostics import compute_diagnostics, derive_taus
from .fes import compute_kde_fes, fes_from_dataset

__all__ = [
    "MSMDiscretizationResult",
    "discretize_dataset",
    "prepare_msm_discretization",
    "ensure_msm_inputs_whitened",
    "apply_whitening_from_metadata",
    "expected_pairs",
    "validate_features",
    "compute_analysis_debug",
    "export_analysis_debug",
    "AnalysisDebugData",
    "compute_diagnostics",
    "derive_taus",
    "compute_kde_fes",
    "fes_from_dataset",
    "GridDiscretizer",
]
