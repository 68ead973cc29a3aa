"""CV training facade (reference: src/pmarlo/cv/__init__.py:15
train_cv_model(method="tica"|"deeptica")).

Port of ``pmarlo_tpu/cv/__init__.py``: ``"tica"`` fits ``msm.reduction.tica``
and ``"deeptica"`` trains ``ml.deeptica.train_deeptica``, both on
``device``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..ml.deeptica import DeepTICAConfig, DeepTICAModel, train_deeptica
from ..msm.reduction import ReductionModel, tica


def train_cv_model(
    X_list: "np.ndarray | Sequence[np.ndarray]",
    method: str = "deeptica",
    *,
    lag: int = 10,
    n_out: int = 2,
    config: Optional[DeepTICAConfig] = None,
    device=None,
) -> Union[DeepTICAModel, ReductionModel]:
    """Train a CV model: linear TICA or nonlinear DeepTICA, on ``device``
    (``None``: ``_device.default_device()``)."""
    if method == "tica":
        seqs = X_list if isinstance(X_list, (list, tuple)) else [X_list]
        return tica([np.asarray(x) for x in seqs], lag=lag, n_components=n_out,
                    device=device)
    if method == "deeptica":
        cfg = config or DeepTICAConfig(lag=lag, n_out=n_out)
        return train_deeptica(X_list, cfg, device=device)
    raise ValueError(f"unknown CV method {method!r} (use 'tica' or 'deeptica')")


__all__ = ["train_cv_model"]
