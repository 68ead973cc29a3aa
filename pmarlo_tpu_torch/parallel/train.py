"""Data-parallel DeepTICA training step over the batch axis of a mesh.

Port of ``pmarlo_tpu/parallel/train.py``. Every rank is given the global
(B, K) batch of lagged pairs and runs the MLP on its rows
``[r B / n, (r + 1) B / n)``; the global means and the centred C00 / C0t /
Ctt (JAX's two-pass form) are all-reduced, so every rank computes the
serial VAMP-2 loss and takes the same step. This is the serial math
distributed, not gradient averaging over micro-batches.

**The gradient.** Each sum runs through ``_RankSum``: an ``all_reduce``
forward whose backward all-reduces the cotangent (the transpose of a sum
over ranks), as JAX's ``psum`` transposes. Every rank holds the same
loss, so that backward counts it once a rank: a rank's autograd result is
``n`` times the gradient of the loss through its own rows. The step
therefore backpropagates ``loss / n`` and then all-reduces the parameter
gradients, which gives the gradient of the concatenated batch on every
rank. A backward that passed the cotangent through unchanged would drop
the cross-rank part of the centring (each rank's rows of ``y - mean`` do
not sum to zero), and one that all-reduced without the ``1 / n`` would be
``n`` times too large (JAX measured 8x). DDP's averaging is not used.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ml.deeptica import DeepTICAConfig, init_mlp_params, mlp_apply
from ..ml.losses import vamp2_loss_from_covariances
from .mesh import all_reduce_sum, check_mesh, mesh_block, rank_device


class _RankSum(torch.autograd.Function):
    """Sum over the mesh's ranks; its backward is the same sum of the
    cotangents."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(t.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.mesh), None


def _leaves(params) -> List[torch.Tensor]:
    return [layer[k] for layer in params for k in ("w", "b")]


def make_data_parallel_step(
    config: DeepTICAConfig,
    tx: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
    mesh,
    axis: "str | None" = None,
    *,
    grad_clip: Optional[float] = None,
) -> Callable:
    """``step(params, opt_state, z0, zt) -> (params, opt_state, loss)``.

    ``params`` are ``ml.deeptica.init_mlp_params``'s layers on this rank's
    device; ``tx(leaves)`` builds the ``torch.optim.Optimizer`` over their
    leaves (JAX's ``optax`` transformation), and ``opt_state`` is that
    optimizer (``None`` at the first step: the step builds it).
    ``z0``/``zt`` are the global (B, K) batch; B must divide over the mesh.
    ``grad_clip`` clips the global gradient norm before the optimizer step
    (``optax.clip_by_global_norm`` first in JAX's chain). The parameters
    are updated in place, identically on every rank."""
    check_mesh(mesh, axis)
    n_dev = mesh.size()

    def step(params, opt_state, z0, zt):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if opt_state is None:
            opt_state = tx(leaves)
        dev = leaves[0].device
        n_global = int(z0.shape[0])
        lo, hi = mesh_block(n_global, mesh, "the batch")
        z0 = torch.as_tensor(z0)[lo:hi].to(device=dev, dtype=torch.float32)
        zt = torch.as_tensor(zt)[lo:hi].to(device=dev, dtype=torch.float32)
        opt_state.zero_grad(set_to_none=True)
        y0 = mlp_apply(params, z0, config.activation, config.layernorm)
        yt = mlp_apply(params, zt, config.activation, config.layernorm)
        # exact global mean-centred covariances, two-pass deviation form
        m0 = _RankSum.apply(y0.sum(0), mesh) / n_global
        mt = _RankSum.apply(yt.sum(0), mesh) / n_global
        a, b = y0 - m0, yt - mt
        C00 = _RankSum.apply(a.T @ a, mesh) / n_global
        C0t = _RankSum.apply(a.T @ b, mesh) / n_global
        Ctt = _RankSum.apply(b.T @ b, mesh) / n_global
        loss, _ = vamp2_loss_from_covariances(
            C00, C0t, Ctt, ridge=config.vamp_ridge, alpha=config.vamp_alpha)
        (loss / n_dev).backward()
        for p in leaves:
            all_reduce_sum(p.grad, mesh)
        if grad_clip is not None:
            torch.nn.utils.clip_grad_norm_(leaves, grad_clip)
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


def train_deeptica_data_parallel(
    z0, zt,
    config: DeepTICAConfig,
    mesh,
    *,
    n_epochs: int = 20,
    axis: "str | None" = None,
) -> Tuple[list, list]:
    """Minimal sharded training loop over a fixed pair set on this rank's
    device: AdamW after the global-norm clip (``ml/deeptica.py``'s order);
    returns (params, per-epoch losses)."""
    from ..utils.seed import set_global_seed

    if not dist.is_initialized():
        raise ValueError("no process group is initialised")
    dev = rank_device(mesh)
    gen = set_global_seed(config.seed, device=dev)
    params = init_mlp_params(gen, int(np.shape(z0)[1]), config.hidden, config.n_out)

    def tx(leaves):
        return torch.optim.AdamW(leaves, lr=config.learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=config.weight_decay)

    step = make_data_parallel_step(config, tx, mesh, axis, grad_clip=config.grad_clip)
    z0 = torch.as_tensor(np.asarray(z0, np.float32), device=dev)
    zt = torch.as_tensor(np.asarray(zt, np.float32), device=dev)
    opt_state, losses = None, []
    for _ in range(n_epochs):
        params, opt_state, loss = step(params, opt_state, z0, zt)
        losses.append(float(loss))
    return [{k: v.detach() for k, v in layer.items()} for layer in params], losses


__all__ = ["make_data_parallel_step", "train_deeptica_data_parallel"]
