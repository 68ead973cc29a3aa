"""VAMP-2 objective with stabilized covariance inverses.

Port of ``pmarlo_tpu/ml/losses.py``: weighted covariances, trace-scaled
ridge + alpha-shrinkage, symmetric cleanup, jitter-ladder Cholesky,
score = ||K||_F^2 via triangular solves, condition-number metrics.
Everything stays float32, as in the JAX version; stability comes from the
ridge, the shrinkage and the jitter ladder.

The JAX ladder selects among four factorizations with ``where`` because a
failed Cholesky there returns NaN. ``torch.linalg.cholesky_ex`` reports
failure through ``info`` and poisons nothing, so the ladder here is a
Python loop that returns the first rung (0, 1e-6, 1e-4, 1e-2 x the mean
trace) whose factor is finite; only that rung enters the autograd graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .._device import default_device

_JITTER_LADDER = (0.0, 1e-6, 1e-4, 1e-2)


def _covariances(
    z0: torch.Tensor,
    zt: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean-centered (C00, C0t, Ctt) with optional pair weights."""
    if weights is None:
        w = torch.ones(z0.shape[0], dtype=z0.dtype, device=z0.device)
    else:
        w = weights.to(z0.dtype)
    wsum = w.sum() + 1e-12
    wn = (w / wsum)[:, None]
    m0 = (wn * z0).sum(0)
    mt = (wn * zt).sum(0)
    a = z0 - m0
    b = zt - mt
    C00 = (a * wn).T @ a
    C0t = (a * wn).T @ b
    Ctt = (b * wn).T @ b
    return C00, C0t, Ctt


def _regularize(C: torch.Tensor, ridge: float, alpha: float) -> torch.Tensor:
    """Trace-scaled ridge + alpha-shrinkage toward scaled identity,
    symmetric cleanup."""
    k = C.shape[0]
    eye = torch.eye(k, dtype=C.dtype, device=C.device)
    C = 0.5 * (C + C.T)
    tr = torch.trace(C) / k
    C = (1.0 - alpha) * C + alpha * tr * eye
    return C + ridge * torch.clamp(tr, min=1e-12) * eye


def _stable_cholesky(C: torch.Tensor) -> torch.Tensor:
    """Cholesky with the fixed jitter ladder: the first rung whose factor
    exists and is finite; the last rung is returned whatever it gave."""
    k = C.shape[0]
    tr = torch.clamp(torch.trace(C) / k, min=1e-12)
    eye = torch.eye(k, dtype=C.dtype, device=C.device)
    L = None
    for jitter in _JITTER_LADDER:
        L, info = torch.linalg.cholesky_ex(C + jitter * tr * eye)
        if int(info) == 0 and bool(torch.isfinite(L).all()):
            break
    return L


def vamp2_loss(
    z0: torch.Tensor,
    zt: torch.Tensor,
    *,
    ridge: float = 1e-4,
    alpha: float = 0.05,
    weights: Optional[torch.Tensor] = None,
    cond_penalty: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Negative VAMP-2 score of a batch of lagged CV pairs.

    Returns (loss, metrics). score = ||L00^-1 C0t Ltt^-T||_F^2 via
    triangular solves; optional log-condition-number penalty."""
    C00, C0t, Ctt = _covariances(z0, zt, weights)
    return vamp2_loss_from_covariances(
        C00, C0t, Ctt, ridge=ridge, alpha=alpha, cond_penalty=cond_penalty
    )


def vamp2_loss_from_covariances(
    C00: torch.Tensor,
    C0t: torch.Tensor,
    Ctt: torch.Tensor,
    *,
    ridge: float = 1e-4,
    alpha: float = 0.05,
    cond_penalty: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """VAMP-2 loss given mean-centered covariance blocks (the shared tail
    of ``vamp2_loss``). The metrics are detached."""
    C00 = _regularize(C00, ridge, alpha)
    Ctt = _regularize(Ctt, ridge, alpha)

    L00 = _stable_cholesky(C00)
    Ltt = _stable_cholesky(Ctt)
    # K = L00^-1 C0t Ltt^-T
    tmp = torch.linalg.solve_triangular(L00, C0t, upper=False)
    K = torch.linalg.solve_triangular(Ltt, tmp.T, upper=False).T
    score = (K * K).sum()

    # condition numbers via eigvalsh of the regularized covariances
    ev00 = torch.linalg.eigvalsh(C00)
    evtt = torch.linalg.eigvalsh(Ctt)
    cond00 = ev00[-1] / torch.clamp(ev00[0], min=1e-30)
    condtt = evtt[-1] / torch.clamp(evtt[0], min=1e-30)

    loss = -score
    if cond_penalty > 0:
        loss = loss + cond_penalty * (torch.log(cond00) + torch.log(condtt))

    metrics = {
        "vamp2": score.detach().to(torch.float32),
        "cond_C00": cond00.detach().to(torch.float32),
        "cond_Ctt": condtt.detach().to(torch.float32),
        "output_variance": torch.diagonal(C00).mean().detach().to(torch.float32),
        "singular_sum": torch.sqrt(score).detach().to(torch.float32),
    }
    return loss.to(torch.float32), metrics


def vamp2_score_features(x0, xt, ridge: float = 1e-4, device=None) -> float:
    """VAMP-2 proxy baseline on raw (scaled) features, computed on
    ``device`` (``None``: ``_device.default_device()``)."""
    device = torch.device(device) if device is not None else default_device()
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    xt = torch.as_tensor(xt, dtype=torch.float32, device=device)
    with torch.no_grad():
        _, metrics = vamp2_loss(x0, xt, ridge=ridge)
    return float(metrics["vamp2"])


__all__ = ["vamp2_loss", "vamp2_loss_from_covariances", "vamp2_score_features"]
