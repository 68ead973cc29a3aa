"""Learned collective variables: DeepTICA MLPs trained with VAMP-2.

Port of ``pmarlo_tpu/ml`` (``deeptica``, ``losses``, ``whitening``,
``plumed``: the TorchScript export and its PLUMED input). The
trained CV is a plain function of tensors, so bias energies compose into
the MD forces by autograd (``bias/``) or run inside the fused CUDA kernel
(``md/fused_md.py``).
"""

from .deeptica import DeepTICAConfig, DeepTICAModel, deeptica_from_numpy, train_deeptica
from .losses import vamp2_loss
from .whitening import apply_output_transform

__all__ = [
    "DeepTICAConfig",
    "DeepTICAModel",
    "deeptica_from_numpy",
    "train_deeptica",
    "vamp2_loss",
    "apply_output_transform",
]
