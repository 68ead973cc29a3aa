"""PyTorch/CUDA port of pmarlo_tpu: REMD -> MSM/FES on an NVIDIA GPU.

The package mirrors ``pmarlo_tpu``'s module paths. Plain tensor code is
PyTorch; the fused Langevin chunk (``md/fused_md.py``) is a hand-written
CUDA kernel (``csrc/fused_md.cu``) with a plain PyTorch twin that the CPU
runs. Importing the package pins float32 matmuls to full precision.

Public symbols resolve lazily, as in ``pmarlo_tpu/__init__.py``: the names
of its registry that the port has (``pmarlo_tpu_torch.run_segment``, ...).
``get_version()`` and ``get_info()`` are JAX's, with the backend and the
devices that PyTorch sees (``"cuda"`` and one name a card, else ``"cpu"``).
"""

from __future__ import annotations

import importlib
from typing import Any

from ._precision import pin_fp32

pin_fp32()

__version__ = "0.1.0"

# symbol -> (module, attr), the JAX package's names for the ported modules
_EXPORTS = {
    # settings / utils (``settings`` reads YAML: it needs PyYAML)
    "load_defaults": ("pmarlo_tpu_torch.settings", "load_defaults"),
    "set_global_seed": ("pmarlo_tpu_torch.utils.seed", "set_global_seed"),
    "constants": ("pmarlo_tpu_torch.constants", None),
    "api": ("pmarlo_tpu_torch.api", None),
    "visualization": ("pmarlo_tpu_torch.visualization", None),
    # structure prep
    "Protein": ("pmarlo_tpu_torch.protein.protein", "Protein"),
    "solvate_structure": ("pmarlo_tpu_torch.protein.solvate", "solvate_structure"),
    "repair_missing_atoms": ("pmarlo_tpu_torch.protein.repair", "repair_missing_atoms"),
    # MD core
    "System": ("pmarlo_tpu_torch.md.system", "System"),
    "MDState": ("pmarlo_tpu_torch.md.integrate", "MDState"),
    "build_system": ("pmarlo_tpu_torch.md.forcefield", "build_system"),
    "run_segment": ("pmarlo_tpu_torch.md.simulation", "run_segment"),
    "build_pair_force_fn": ("pmarlo_tpu_torch.md.pair_force", "build_pair_force_fn"),
    "build_periodic_force_fn": ("pmarlo_tpu_torch.md.periodic_force",
                                "build_periodic_force_fn"),
    "build_h_constraints": ("pmarlo_tpu_torch.md.constraints", "build_h_constraints"),
    "build_cell_force_fn": ("pmarlo_tpu_torch.md.cell_force", "build_cell_force_fn"),
    "ewald_energy_dense": ("pmarlo_tpu_torch.md.pme", "ewald_energy_dense"),
    "run_npt": ("pmarlo_tpu_torch.md.barostat", "run_npt"),
    # REMD
    "RemdConfig": ("pmarlo_tpu_torch.remd.remd", "RemdConfig"),
    "ReplicaExchange": ("pmarlo_tpu_torch.remd.remd", "ReplicaExchange"),
    "run_replica_exchange": ("pmarlo_tpu_torch.remd.remd", "run_replica_exchange"),
    "suggest_temperature_ladder": ("pmarlo_tpu_torch.remd.ladder",
                                   "suggest_temperature_ladder"),
    "save_checkpoint": ("pmarlo_tpu_torch.remd.checkpoint", "save_checkpoint"),
    "load_checkpoint": ("pmarlo_tpu_torch.remd.checkpoint", "load_checkpoint"),
    # dashboard (reference pmarlo_webapp)
    "export_dashboard": ("pmarlo_tpu_torch.webapp", "export_static"),
    "serve_dashboard": ("pmarlo_tpu_torch.webapp", "serve"),
    # features
    "FEATURE_REGISTRY": ("pmarlo_tpu_torch.features.base", "FEATURE_REGISTRY"),
    "get_feature": ("pmarlo_tpu_torch.features.base", "get_feature"),
    "register_feature": ("pmarlo_tpu_torch.features.base", "register_feature"),
    "parse_feature_spec": ("pmarlo_tpu_torch.features.base", "parse_feature_spec"),
    "featurize_trajectory": ("pmarlo_tpu_torch.features.featurize", "featurize_trajectory"),
    "compute_ramachandran": ("pmarlo_tpu_torch.features.ramachandran",
                             "compute_ramachandran"),
    "dssp": ("pmarlo_tpu_torch.features.structure", "dssp"),
    "ss_fractions_dssp": ("pmarlo_tpu_torch.features.structure", "ss_fractions_dssp"),
    "baker_hubbard": ("pmarlo_tpu_torch.features.structure", "baker_hubbard"),
    # ML CVs
    "DeepTICAConfig": ("pmarlo_tpu_torch.ml.deeptica", "DeepTICAConfig"),
    "DeepTICAModel": ("pmarlo_tpu_torch.ml.deeptica", "DeepTICAModel"),
    "train_deeptica": ("pmarlo_tpu_torch.ml.deeptica", "train_deeptica"),
    # MSM
    "MarkovStateModel": ("pmarlo_tpu_torch.msm.enhanced", "EnhancedMSM"),
    "EnhancedMSM": ("pmarlo_tpu_torch.msm.enhanced", "EnhancedMSM"),
    "run_complete_msm_analysis": ("pmarlo_tpu_torch.msm.enhanced",
                                  "run_complete_msm_analysis"),
    "generate_2d_fes": ("pmarlo_tpu_torch.msm.free_energy", "generate_2d_fes"),
    "generate_1d_pmf": ("pmarlo_tpu_torch.msm.free_energy", "generate_1d_pmf"),
    "FESResult": ("pmarlo_tpu_torch.msm.free_energy", "FESResult"),
    "PMFResult": ("pmarlo_tpu_torch.msm.free_energy", "PMFResult"),
    "candidate_lag_ladder": ("pmarlo_tpu_torch.utils.msm_utils", "candidate_lag_ladder"),
    # shards
    "write_shard": ("pmarlo_tpu_torch.io.shards", "write_shard"),
    "read_shard": ("pmarlo_tpu_torch.io.shards", "read_shard"),
    "select_shard_paths": ("pmarlo_tpu_torch.io.shards", "select_shard_paths"),
    # conformations
    "find_conformations": ("pmarlo_tpu_torch.conformations.finder", "find_conformations"),
    # fused enhanced sampling
    "run_fused_metadynamics": ("pmarlo_tpu_torch.md.enhanced_sampling",
                               "run_fused_metadynamics"),
    "MetadynamicsBias": ("pmarlo_tpu_torch.bias.metadynamics", "MetadynamicsBias"),
    "train_cv_model": ("pmarlo_tpu_torch.cv", "train_cv_model"),
    "Pipeline": ("pmarlo_tpu_torch.workflow", "Pipeline"),
}


def __getattr__(name: str) -> Any:
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'pmarlo_tpu_torch' has no attribute {name!r}")
    module = importlib.import_module(module_name)
    return module if attr is None else getattr(module, attr)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


def get_version() -> str:
    return __version__


def get_info() -> dict:
    import torch

    if torch.cuda.is_available():
        backend = "cuda"
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        backend, devices = "cpu", ["cpu"]
    return {"version": __version__, "backend": backend, "devices": devices}


__all__ = ["pin_fp32", "get_version", "get_info"]
