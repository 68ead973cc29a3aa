"""CV bias potentials that compose into the MD forces.

Port of ``pmarlo_tpu/bias``: a bias is a plain function
``bias_fn(positions) -> energy`` of tensors, added to the potential with
its forces taken by autograd (``md/integrate.py make_force_fn``). The same
DeepTICA bias also runs inside the fused CUDA kernel (``md/fused_md.py``).
"""

from .harmonic import HarmonicExpansionBias, make_cv_bias_fn
from .metadynamics import MetadynamicsBias, MetaDState

__all__ = [
    "HarmonicExpansionBias",
    "make_cv_bias_fn",
    "MetadynamicsBias",
    "MetaDState",
]
