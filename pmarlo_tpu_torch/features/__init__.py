"""Featurization: dihedrals, distances, Rg, contacts, registry, the
Ramachandran analysis, and the water-model checks g(r) and MSD.

Port of ``pmarlo_tpu/features`` (``base``, ``builtins``, ``featurize``,
``pairs``, ``ramachandran``, ``rdf``, ``msd``): plain PyTorch over
coordinate tensors on their device.
"""

from .base import (
    FEATURE_REGISTRY,
    FeatureSpec,
    TopologyInfo,
    get_feature,
    parse_feature_spec,
    register_feature,
)
from .builtins import (
    chi1_indices,
    compute_angles,
    compute_dihedrals,
    compute_distances,
    contacts,
    phi_psi_indices,
    radius_of_gyration,
)
from .featurize import featurize_trajectory
from .pairs import lagged_time_pairs, make_training_pairs_from_trajectory
from .ramachandran import compute_ramachandran, compute_ramachandran_fes, periodic_hist2d
from .msd import diffusion_coefficient, mean_squared_displacement, unwrap_trajectory
from .rdf import coordination_number, radial_distribution

__all__ = [
    "FEATURE_REGISTRY",
    "FeatureSpec",
    "TopologyInfo",
    "get_feature",
    "parse_feature_spec",
    "register_feature",
    "compute_dihedrals",
    "compute_distances",
    "compute_angles",
    "phi_psi_indices",
    "chi1_indices",
    "radius_of_gyration",
    "contacts",
    "featurize_trajectory",
    "lagged_time_pairs",
    "make_training_pairs_from_trajectory",
    "compute_ramachandran",
    "compute_ramachandran_fes",
    "periodic_hist2d",
    "radial_distribution",
    "coordination_number",
    "diffusion_coefficient",
    "mean_squared_displacement",
    "unwrap_trajectory",
]
