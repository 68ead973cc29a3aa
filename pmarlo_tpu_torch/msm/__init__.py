"""MSM stack: clustering, counting, estimation, ITS, CK, FES, PCCA+, TPT
and the linear reductions.

Port of ``pmarlo_tpu/msm``. k-means, transition counting, the covariances
of the reductions and the posterior draws of the ITS run on a torch device;
PCCA+, TPT, CK and the small eigensolves are host numpy, as in JAX. Exports
what ``pmarlo_tpu.msm`` exports.
"""

from .clustering import ClusteringResult, cluster_microstates, kmeans
from .counting import count_transitions, counts_from_dtrajs
from .estimation import MSMResult, build_msm, estimate_transition_matrix
from .free_energy import FESResult, PMFResult, generate_1d_pmf, generate_2d_fes
from .its import ITSResult, compute_implied_timescales
from .reversible_sampler import (
    sample_reversible_posterior,
    sample_reversible_timescales,
)
from .ck import CKResult, ck_test
from .pcca import pcca_memberships
from .tpt import TPTResult, committors, reactive_flux
from .reduction import reduce_features, tica, vamp, pca

__all__ = [
    "ClusteringResult",
    "cluster_microstates",
    "kmeans",
    "count_transitions",
    "counts_from_dtrajs",
    "MSMResult",
    "build_msm",
    "estimate_transition_matrix",
    "FESResult",
    "PMFResult",
    "generate_1d_pmf",
    "generate_2d_fes",
    "ITSResult",
    "compute_implied_timescales",
    "sample_reversible_posterior",
    "sample_reversible_timescales",
    "CKResult",
    "ck_test",
    "pcca_memberships",
    "TPTResult",
    "committors",
    "reactive_flux",
    "reduce_features",
    "tica",
    "vamp",
    "pca",
]
