"""(Well-tempered) metadynamics in CV space with a fixed-capacity hills ledger.

Port of ``pmarlo_tpu/bias/metadynamics.py``. The ledger is a dataclass of
tensors (centers, heights, valid count) of fixed capacity, the layout the
fused kernels read and write (``md/fused_md.py``): row ``h`` of ``centers``
is hill ``h``. Reweighting uses the standard e^{beta V} factors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._device import default_device
from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL


@dataclasses.dataclass(frozen=True)
class MetaDState:
    """Hills ledger: fixed capacity, ``n_hills`` marks the valid prefix."""

    centers: torch.Tensor   # (H_max, n_cv)
    heights: torch.Tensor   # (H_max,)
    n_hills: torch.Tensor   # () int32

    def to(self, device) -> "MetaDState":
        return MetaDState(self.centers.to(device), self.heights.to(device),
                          self.n_hills.to(device))


def metad_state_from_numpy(centers, heights, n_hills, device=None) -> MetaDState:
    """A ledger from host arrays (e.g. a JAX ``MetaDState``'s fields), on
    ``device`` (``None``: ``_device.default_device()``)."""
    device = torch.device(device) if device is not None else default_device()
    return MetaDState(
        centers=torch.as_tensor(np.array(centers, dtype=np.float32), device=device),
        heights=torch.as_tensor(np.array(heights, dtype=np.float32), device=device),
        n_hills=torch.as_tensor(int(n_hills), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass(frozen=True)
class MetadynamicsBias:
    """Gaussian-hills bias with optional well-tempered height damping.

    Parameters mirror PLUMED conventions: ``height`` (kJ/mol), ``sigma``
    per-CV widths, ``bias_factor`` gamma (None -> standard metadynamics),
    ``temperature_K`` for well-tempered damping.
    """

    sigma: Tuple[float, ...]
    height: float = 1.0
    max_hills: int = 4096
    bias_factor: Optional[float] = None     # gamma > 1 for well-tempered
    temperature_K: float = 300.0

    def init_state(self, n_cv: Optional[int] = None, device=None) -> MetaDState:
        """An empty ledger on ``device`` (``None``: ``_device.default_device()``)."""
        n_cv = n_cv or len(self.sigma)
        device = torch.device(device) if device is not None else default_device()
        return MetaDState(
            centers=torch.zeros((self.max_hills, n_cv), dtype=torch.float32, device=device),
            heights=torch.zeros(self.max_hills, dtype=torch.float32, device=device),
            n_hills=torch.zeros((), dtype=torch.int32, device=device),
        )

    def energy(self, state: MetaDState, cv: torch.Tensor) -> torch.Tensor:
        """Bias energy at CV points ``(..., n_cv) -> (...)``: masked sum
        over deposited hills."""
        sigma = torch.as_tensor(self.sigma, dtype=cv.dtype, device=cv.device)
        d = (cv[..., None, :] - state.centers) / sigma
        g = torch.exp(-0.5 * (d * d).sum(-1))
        mask = (
            torch.arange(state.heights.shape[0], device=cv.device) < state.n_hills
        ).to(cv.dtype)
        return (state.heights * g * mask).sum(-1)

    def deposit(self, state: MetaDState, cv: torch.Tensor) -> MetaDState:
        """Add one hill at ``cv (n_cv,)`` (well-tempered damping if
        configured). Writes at index ``n_hills``; a full ledger drops the
        deposit. No host synchronisation: the write is a masked select."""
        h = torch.as_tensor(self.height, dtype=cv.dtype, device=cv.device)
        if self.bias_factor is not None:
            if self.bias_factor <= 1.0:
                raise ValueError("bias_factor must be > 1")
            delta_T = (self.bias_factor - 1.0) * self.temperature_K
            v_here = self.energy(state, cv)
            h = h * torch.exp(-v_here / (BOLTZMANN_CONSTANT_KJ_PER_MOL * delta_T))
        capacity = state.heights.shape[0]
        write = (
            torch.arange(capacity, device=cv.device) == state.n_hills
        )                                   # all False when the ledger is full
        return MetaDState(
            centers=torch.where(write[:, None], cv[None, :], state.centers),
            heights=torch.where(write, h, state.heights),
            n_hills=state.n_hills + write.any().to(torch.int32),
        )

    def bias_fn(
        self,
        state: MetaDState,
        cv_from_positions: Callable[[torch.Tensor], torch.Tensor],
    ) -> Callable[[torch.Tensor], torch.Tensor]:
        """positions -> metadynamics energy (closure over a fixed ledger)."""

        def fn(positions: torch.Tensor) -> torch.Tensor:
            return self.energy(state, cv_from_positions(positions))

        return fn

    def reproject(
        self,
        state: MetaDState,
        old_to_new_cv: Callable[[torch.Tensor], torch.Tensor],
    ) -> MetaDState:
        """Map hill centers through a new CV model after retraining. Valid
        only when the stored centers live in the function's INPUT space;
        otherwise recompute them from the hills' configuration-space
        anchors and use ``set_centers``."""
        new_centers = torch.stack([old_to_new_cv(c) for c in state.centers])
        return self.set_centers(state, new_centers)

    def set_centers(self, state: MetaDState, new_centers) -> MetaDState:
        """Replace hill centers (heights and count kept)."""
        new_centers = torch.as_tensor(new_centers, device=state.centers.device)
        if new_centers.shape != state.centers.shape:
            raise ValueError(
                f"need centers of shape {tuple(state.centers.shape)} "
                f"(all ledger slots), got {tuple(new_centers.shape)}"
            )
        return MetaDState(
            centers=new_centers.to(state.centers.dtype),
            heights=state.heights,
            n_hills=state.n_hills,
        )

    def reweighting_factors(
        self, state: MetaDState, cvs, temperature_K: Optional[float] = None
    ) -> np.ndarray:
        """w_i proportional to exp(+V_bias(cv_i)/kT) for unbiasing histograms."""
        T = temperature_K or self.temperature_K
        kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * T
        cvs = torch.as_tensor(np.asarray(cvs), dtype=torch.float32,
                              device=state.centers.device)
        v = self.energy(state, cvs)
        v = v - v.max()
        return torch.exp(v / kT).cpu().numpy()


__all__ = ["MetadynamicsBias", "MetaDState", "metad_state_from_numpy"]
