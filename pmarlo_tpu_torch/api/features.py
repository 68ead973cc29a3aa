"""Feature API: cached featurization, universal metric, alignment.

Reference: src/pmarlo/api/features.py — compute_features with content-hash
feature cache (:27-75, :192), compute_universal_metric/_embedding
(:345,:423), align_trajectory (:110), trig_expand_periodic (:138).

Port of ``pmarlo_tpu/api/features.py``. Every function takes JAX's
arguments plus ``device=``: the features, the alignment and the expansion
run on the tensor's own device, or a host array's on ``device`` (``None``:
``_device.default_device()``, the card when there is one), as
``featurize_trajectory`` places its input. Each hands back what JAX's
hands back, a host ``np.ndarray`` (one device-to-host copy of the result).
The content hash and the cache stay on host numpy, as JAX's do; the hash
reads only the strided frames it samples, so a trajectory on the card
crosses to the host in those frames alone.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device
from ..features.base import TopologyInfo
from ..features.builtins import align_to_reference
from ..features.builtins import trig_expand_periodic as _trig_expand
from ..features.featurize import featurize_trajectory, frames_on_device
from ..msm.reduction import pca

_FEATURE_CACHE: Dict[str, Tuple[np.ndarray, Dict]] = {}
_CACHE_LIMIT = 32


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _placed(x, device) -> torch.Tensor:
    """``x`` as a tensor: a tensor on its own device (or on ``device`` when
    one is given), a host array as float32 on ``device``, else on
    ``default_device()``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    dev = torch.device(device) if device is not None else default_device()
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)


def _content_hash(traj, spec, top: TopologyInfo) -> str:
    """Content hash over coordinates + spec + topology names
    (reference api/features.py:27-75): the shape and every
    ``max(T // 64, 1)``-th frame as float32 bytes, as JAX hashes them."""
    h = hashlib.sha256()
    if not isinstance(traj, torch.Tensor):
        traj = np.asarray(traj)
    shape = tuple(int(n) for n in traj.shape)
    sample = np.ascontiguousarray(np.asarray(_host(traj[:: max(shape[0] // 64, 1)]),
                                             dtype=np.float32))
    h.update(shape.__repr__().encode())
    h.update(sample.tobytes())  # strided content sample
    h.update(str(spec).encode())
    h.update(",".join(top.atom_names).encode())
    return h.hexdigest()


def compute_features(
    traj,
    spec: "str | Sequence[str]",
    top: TopologyInfo,
    *,
    cos_sin_expand: bool = False,
    use_cache: bool = True,
    device=None,
) -> Tuple[np.ndarray, Dict]:
    """Featurize with an in-process content-hash cache
    (reference api/features.py:192). ``X`` is a host array, as JAX's."""
    if not isinstance(traj, torch.Tensor):
        traj = np.asarray(traj)
    key = _content_hash(traj, (spec, cos_sin_expand), top) if use_cache else None
    if key is not None and key in _FEATURE_CACHE:
        return _FEATURE_CACHE[key]
    X, info = featurize_trajectory(traj, spec, top, cos_sin_expand=cos_sin_expand,
                                   device=device)
    X = _host(X)
    if key is not None:
        if len(_FEATURE_CACHE) >= _CACHE_LIMIT:
            _FEATURE_CACHE.pop(next(iter(_FEATURE_CACHE)))
        _FEATURE_CACHE[key] = (X, info)
    return X, info


def clear_feature_cache() -> None:
    _FEATURE_CACHE.clear()


def align_trajectory(traj, reference=None, *, device=None) -> np.ndarray:
    """Kabsch-align all frames onto a reference (default: first frame)
    (reference api/features.py:110)."""
    x = frames_on_device(traj, device)
    ref = x[0] if reference is None else reference
    return _host(align_to_reference(x, ref))


def trig_expand_periodic(X, *, device=None) -> np.ndarray:
    """(reference api/features.py:138)."""
    return _host(_trig_expand(_placed(X, device)))


def compute_universal_metric(
    traj, top: TopologyInfo, *, n_components: int = 1, device=None
) -> np.ndarray:
    """A single scalar 'universal' progress metric per frame: first PC of
    the pooled standard feature set (reference api/features.py:345)."""
    emb = compute_universal_embedding(traj, top, n_components=n_components, device=device)
    return emb[:, 0]


def compute_universal_embedding(
    traj, top: TopologyInfo, *, n_components: int = 2, device=None
) -> np.ndarray:
    """PCA embedding of the pooled universal features (phi/psi cos-sin + Rg
    + CA distances) (reference api/features.py:423): the three blocks come
    back from ``compute_features`` as host arrays; the pooling and the PCA
    are host numpy, as in JAX."""
    blocks = []
    try:
        X, _ = compute_features(traj, "phi_psi", top, cos_sin_expand=True, device=device)
        blocks.append(X)
    except (ValueError, KeyError):
        pass
    try:
        X, _ = compute_features(traj, "rg", top, device=device)
        blocks.append(X)
    except (ValueError, KeyError):
        pass
    try:
        X, _ = compute_features(traj, "ca_distances", top, device=device)
        blocks.append(X)
    except (ValueError, KeyError):
        pass
    if not blocks:
        raise ValueError("no universal features computable for this system")
    pooled = np.concatenate(blocks, axis=1)
    mu, sd = pooled.mean(0), pooled.std(0)
    sd[sd < 1e-12] = 1.0
    model = pca((pooled - mu) / sd, n_components=n_components)
    return model.transform((pooled - mu) / sd)


__all__ = [
    "compute_features",
    "clear_feature_cache",
    "align_trajectory",
    "trig_expand_periodic",
    "compute_universal_metric",
    "compute_universal_embedding",
]
