"""Fused enhanced sampling: well-tempered metadynamics in one launch.

Port of ``pmarlo_tpu/md/enhanced_sampling.py``. The ENTIRE metadynamics
run (MD steps, CV evaluation, well-tempered hill deposition) executes
inside one launch of the fused CUDA kernel (``md/fused_md.py``,
``mtd_deposit_interval`` mode): the hills ledger lives in device memory,
every replica's CTA meets the others at a grid barrier after each deposit
window, and the updated ledger comes back as an output. No host round
trip per deposit.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import default_device
from ..bias.metadynamics import MetadynamicsBias, MetaDState
from .fused_md import FusedChunk, build_fused_chunk
from .system import System


def run_fused_metadynamics(
    system: System,
    positions: torch.Tensor,
    *,
    cv_model,
    cv_quads: np.ndarray,
    mtd: MetadynamicsBias,
    n_steps: int,
    deposit_interval: int = 500,
    n_replicas: int = 1,
    temperature_K: float = 300.0,
    dt_ps: float = 0.002,
    friction_per_ps: float = 1.0,
    seed: int = 0,
    hills: Optional[MetaDState] = None,
    chunk: Optional[FusedChunk] = None,
    device=None,
) -> Dict:
    """Run metadynamics with MD, CV, and hill deposition fused into a
    single kernel launch, on ``device`` (``None``: the card when there is
    one; on the CPU the kernel's plain version runs).

    Every ``deposit_interval`` steps each replica deposits one
    (well-tempered) hill at its current DeepTICA CV, in replica order.
    Returns the final state, the updated hills ledger and the reusable
    ``"chunk"``."""
    if n_steps % deposit_interval != 0:
        raise ValueError("n_steps must be a multiple of deposit_interval")
    dev = torch.device(device) if device is not None else default_device()
    system = system.to(dev)
    chunk = chunk or build_fused_chunk(
        system,
        dt=dt_ps,
        friction=friction_per_ps,
        n_replicas=n_replicas,
        bias_model=cv_model,
        bias_quads=cv_quads,
        bias_kind="metadynamics",
        mtd_sigma=np.asarray(mtd.sigma),
        mtd_deposit_interval=deposit_interval,
        mtd_height=float(mtd.height),
        mtd_bias_factor=mtd.bias_factor,
        mtd_temperature_K=float(mtd.temperature_K),
    )
    n_cv = len(mtd.sigma)
    hills = mtd.init_state(n_cv, device=dev) if hills is None else hills.to(dev)

    R = n_replicas
    positions = positions.to(device=dev, dtype=torch.float32)
    x = positions[None].expand((R,) + tuple(positions.shape)).contiguous()
    v = torch.zeros_like(x)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    seeds = torch.randint(
        0, 2**31 - 1, (R,), generator=gen, device=dev, dtype=torch.int64
    ).to(torch.int32)
    temps = torch.full((R,), float(temperature_K), dtype=torch.float32, device=dev)

    x, v, energies, final_hills = chunk(x, v, seeds, temps, n_steps, 0, hills=hills)
    return {
        "positions": x,
        "velocities": v,
        "potential_energy": energies,
        "hills": final_hills,
        "n_windows": n_steps // deposit_interval,
        "chunk": chunk,
    }


__all__ = ["run_fused_metadynamics"]
