"""PyTorch/CUDA port of pmarlo_tpu: REMD -> MSM/FES on an NVIDIA GPU.

The package mirrors ``pmarlo_tpu``'s module paths. Plain tensor code is
PyTorch; the fused Langevin chunk (``md/fused_md.py``) is a hand-written
CUDA kernel (``csrc/fused_md.cu``) with a plain PyTorch twin that the CPU
runs. Importing the package pins float32 matmuls to full precision.
"""

from ._precision import pin_fp32

pin_fp32()

__all__ = ["pin_fp32"]
