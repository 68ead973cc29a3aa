"""Energy minimization: FIRE descent.

Port of ``pmarlo_tpu/md/minimize.py``: the same FIRE update with the same
constants, a Python loop in place of ``lax.scan``, autograd forces of
``forces.potential_energy`` by default, through the expansion of the
system's virtual sites (``md/vsites.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .system import System
from .vsites import VirtualSites, expanded_energy_and_forces


def minimize_energy(
    system: System,
    positions: torch.Tensor,
    *,
    max_iterations: int = 500,
    dt_start: float = 1e-4,
    dt_max: float = 2e-3,
    force_fn: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]] = None,
    bias_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIRE minimization of one configuration ``(N, 3)``.
    Returns ``(positions, final_energy)``. ``force_fn`` (x -> (energy,
    forces)) replaces the autograd path; ``bias_fn`` (positions -> energy)
    is added to either. Virtual-site rows are re-derived from their
    parents in the positions returned (the autograd path composes their
    expansion into the energy; a given ``force_fn`` spreads their forces)."""
    if bias_fn is not None:
        from .integrate import compose_bias

        base = force_fn or (lambda x: expanded_energy_and_forces(system, x))
        force_fn = compose_bias(base, bias_fn)
    if force_fn is None:
        def neg_grad(x):
            return expanded_energy_and_forces(system, x)[1]

        def energy_fn(x):
            return expanded_energy_and_forces(system, x)[0]
    else:
        def neg_grad(x):
            return force_fn(x)[1]

        def energy_fn(x):
            return force_fn(x)[0]

    f_inc, f_dec, alpha_start, f_alpha, n_min = 1.1, 0.5, 0.1, 0.99, 5
    max_disp = 0.01  # nm per iteration per atom
    x = positions.detach().clone()
    v = torch.zeros_like(x)
    dt = torch.tensor(dt_start, dtype=x.dtype, device=x.device)
    alpha = torch.tensor(alpha_start, dtype=x.dtype, device=x.device)
    n_pos = torch.tensor(0, dtype=torch.int32, device=x.device)
    for _ in range(max_iterations):
        f = neg_grad(x)
        power = (f * v).sum()
        f_norm = torch.sqrt((f * f).sum()) + 1e-12
        v_norm = torch.sqrt((v * v).sum())
        v_mixed = (1.0 - alpha) * v + alpha * (f / f_norm) * v_norm

        uphill = power < 0.0
        v_new = torch.where(uphill, torch.zeros_like(v), v_mixed)
        n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        grow = (~uphill) & (n_pos > n_min)
        dt = torch.where(
            uphill, dt * f_dec,
            torch.where(grow, torch.clamp(dt * f_inc, max=dt_max), dt),
        )
        alpha = torch.where(
            uphill, torch.full_like(alpha, alpha_start),
            torch.where(grow, alpha * f_alpha, alpha),
        )
        # semi-implicit Euler with the displacement capped per atom
        v = v_new + dt * f
        step_vec = dt * v
        norm = torch.sqrt((step_vec**2).sum(-1, keepdim=True)) + 1e-12
        x = x + step_vec * torch.clamp(max_disp / norm, max=1.0)
    vs = VirtualSites.from_system(system)
    if vs is not None:
        x = vs.expand(x)
    with torch.no_grad():
        e = energy_fn(x)
    return x, e


__all__ = ["minimize_energy"]
