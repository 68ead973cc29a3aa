"""Roll-layout bonded energies: JAX's ``build_rolled_bonded`` and the
offset grouping it is built on.

Port of ``pmarlo_tpu/md/bonded_roll.py`` (the JAX module leaves it to XLA
and reaches no Pallas kernel). JAX groups bonded terms by their offset
signature ``(j - i, k - i, ...)`` and evaluates each group as one masked
pass over ``roll``ed coordinates, because gathers serialize on a TPU.
Terms of one signature that share a base atom (a torsion's Fourier
multiplicities) go into separate layers (``_layered_groups``, copied from
the JAX module; ``constraints._build_rolled_spec`` builds on it). A card
gathers natively, so the port's ``build_rolled_bonded`` returns the same
energy function through its index-gathered terms (``md/forces.py``): one
implementation of the bonded maths. Forces come from autograd, as JAX
takes ``jax.grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .system import System


def _layered_groups(
    idx: np.ndarray, params: List[np.ndarray], n_atoms: int
) -> List[Tuple[Tuple[int, ...], np.ndarray, List[np.ndarray]]]:
    """Group terms by offset signature; collide same-base terms into
    layers. Returns [(deltas, mask (N,), [param arrays (N,)])]."""
    idx = np.asarray(idx)
    if idx.size == 0:
        return []
    base = idx[:, 0]
    deltas = idx[:, 1:] - base[:, None]
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for t, row in enumerate(deltas):
        groups.setdefault(tuple(int(d) for d in row), []).append(t)

    out = []
    for sig, terms in sorted(groups.items()):
        # layer terms so each base atom appears at most once per layer
        layers: List[List[int]] = []
        seen: List[set] = []
        for t in terms:
            b = int(base[t])
            for layer, s in zip(layers, seen):
                if b not in s:
                    layer.append(t)
                    s.add(b)
                    break
            else:
                layers.append([t])
                seen.append({b})
        for layer in layers:
            mask = np.zeros(n_atoms, np.float32)
            p_arrs = [np.zeros(n_atoms, np.float32) for _ in params]
            b_idx = base[layer]
            mask[b_idx] = 1.0
            for p_arr, p in zip(p_arrs, params):
                p_arr[b_idx] = np.asarray(p)[layer]
            out.append((sig, mask, p_arrs))
    return out


def build_rolled_bonded(system: System) -> Callable[[torch.Tensor], torch.Tensor]:
    """``energy_fn(x (..., N, 3)) -> (...)``: bonds + angles + torsions of
    ``system``, the energy JAX's roll layout evaluates; leading dimensions
    of ``x`` batch."""
    from .forces import angle_energy, bond_energy, torsion_energy

    def energy_fn(x: torch.Tensor) -> torch.Tensor:
        return bond_energy(system, x) + angle_energy(system, x) + torsion_energy(system, x)

    return energy_fn


__all__ = ["build_rolled_bonded"]
