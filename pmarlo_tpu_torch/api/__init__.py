"""Public API facade: the reference's ~40 re-exported helpers
(reference: src/pmarlo/api/__init__.py:16-51), plus the TPU rebuild's
own additions. Both naming conventions are exported where the reference
abbreviates (macro_mfpt == macrostate_mfpt).

Host copy of ``pmarlo_tpu/api/__init__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from ..ml.metrics import (
    normalize_training_metrics,
    resolve_deeptica,
    sanitize_deeptica_payload,
)
from ..msm.reduction import reduce_features
from ..utils.config_utils import deep_merge
from ..utils.input_parsing import (
    parse_bins,
    parse_hidden_layers,
    parse_tau_schedule,
    parse_temperature_ladder,
)
from ..utils.json_io import sanitize_for_json, write_json
from ..utils.misc import slugify, timestamp
from ..utils.path_utils import coerce_path_list, relativize
from ..utils.seed import choose_sim_seed, extract_seed
from .clustering import cluster_microstates
from .conformations import (
    conformations_to_csv,
    conformations_to_json,
    find_conformations_from_msm,
    sanitize_label_for_filename,
)
from .feature_profiles import (
    FEATURE_PROFILES,
    FeatureProfile,
    get_feature_profile,
    get_feature_profile_info,
    load_feature_profile,
    validate_profile_for_cv_biasing,
)
from .features import (
    align_trajectory,
    clear_feature_cache,
    compute_features,
    compute_universal_embedding,
    compute_universal_metric,
    trig_expand_periodic,
)
from .fes import (
    generate_fes_and_pick_minima,
    generate_free_energy_surface,
    select_fes_pair,
)
from .msm import (
    analyze_msm,
    build_msm_from_labels,
    compute_macrostates,
    macrostate_mfpt,
    macrostate_populations,
    macrostate_transition_matrix,
)
from .trajectory_utils import extract_last_frame_to_pdb

# reference-named aliases (src/pmarlo/api/msm.py:519-572, utils/json_io)
macro_mfpt = macrostate_mfpt
macro_transition_matrix = macrostate_transition_matrix
macrostate_populations = macrostate_populations
sanitize = sanitize_for_json

__all__ = [
    "align_trajectory",
    "analyze_msm",
    "build_msm_from_labels",
    "choose_sim_seed",
    "clear_feature_cache",
    "cluster_microstates",
    "coerce_path_list",
    "compute_features",
    "compute_macrostates",
    "compute_universal_embedding",
    "compute_universal_metric",
    "conformations_to_csv",
    "conformations_to_json",
    "deep_merge",
    "extract_last_frame_to_pdb",
    "FEATURE_PROFILES",
    "FeatureProfile",
    "find_conformations_from_msm",
    "generate_fes_and_pick_minima",
    "generate_free_energy_surface",
    "get_feature_profile",
    "get_feature_profile_info",
    "load_feature_profile",
    "macro_mfpt",
    "macro_transition_matrix",
    "macrostate_mfpt",
    "macrostate_populations",
    "macrostate_transition_matrix",
    "normalize_training_metrics",
    "parse_bins",
    "parse_hidden_layers",
    "parse_tau_schedule",
    "parse_temperature_ladder",
    "reduce_features",
    "relativize",
    "resolve_deeptica",
    "sanitize",
    "sanitize_deeptica_payload",
    "sanitize_for_json",
    "sanitize_label_for_filename",
    "select_fes_pair",
    "slugify",
    "timestamp",
    "trig_expand_periodic",
    "validate_profile_for_cv_biasing",
    "write_json",
    "extract_seed",
]
