"""Pin float32 math to full precision on every device.

A float32 matmul may run in TF32 on the card (three decimal digits), and a
float32 convolution does by default. The geometry in this package (pair
distances, k-means distances) needs full float32, so the package turns
TF32 off at import.
"""

from __future__ import annotations

import torch


def pin_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


__all__ = ["pin_fp32"]
