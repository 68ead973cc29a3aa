"""Neighbor-listed nonbonded / GB path: LJ + Coulomb + GBn2/OBC over a
fixed-capacity neighbor list.

Port of ``pmarlo_tpu/md/nblist.py``, plain PyTorch (the JAX module leaves
it to XLA and reaches no Pallas kernel). It is a force path of its own:
O(N M) pair work over ``(N, M)`` tensors with M the list's capacity, for
systems whose dense ``(N, N)`` stages no longer fit, or as a reference.
Every pair term (LJ, Coulomb, the GB cross term, the Born integral and the
GBn2 neck) is taken over the listed pairs only, so the list's cutoff
truncates them all; the GB self and surface terms are per atom.

- ``build_neighbor_list``: each atom's ``capacity`` nearest partners within
  ``cutoff`` by ``torch.topk`` over its row of the masked squared
  distances. Rows are built in chunks, so a build holds ``(rows, N)``
  tensors and never the whole ``(N, N)`` matrix. Both directions of every
  pair are listed; empty slots point at the row's own atom (gathers stay in
  bounds) and carry mask 0. More partners than ``capacity`` saturate at the
  nearest ones; ``n_max`` reports the largest count found and nothing
  checks it. ``topk`` does not promise JAX's order among equal distances:
  only the order of a row's slots, hence of its sums, can differ.
- exclusions are applied in place: each atom carries a padded table of its
  1-2 / 1-3 and 1-4 partners (``make_exclusion_tables``), and each listed
  pair looks its scale up in its row's table.
- forces are the autograd gradient of ``potential_energy_nb``, as JAX takes
  ``jax.grad``.

``run_md_nb`` rebuilds the list at ``cutoff + skin`` every
``rebuild_interval`` steps and integrates Langevin steps against the frozen
list in between; the list is not cut again at ``cutoff`` inside an
evaluation. It evaluates the force once a step (the JAX step's extra
evaluation is dead code that XLA drops) and looks the exclusion scales up
once a rebuild, since they depend on the list and the tables only.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
from .ff_params import SCEE, SCNB
from .forces import (_born_rescale, _gb_f, _gb_prefactor, _gb_self_and_surface,
                     _hct_pair_term, angle_energy, bond_energy, torsion_energy)
from .gbn2 import neck_value_and_derivative
from .system import System

_EPS = 1e-12
#: a list build computes its distance rows this many matrix entries at a time
_BUILD_CHUNK_ENTRIES = 1 << 24


class NeighborList(NamedTuple):
    idx: torch.Tensor    # (N, M) int64 neighbor indices (self-padded)
    mask: torch.Tensor   # (N, M) 1/0 validity, the positions' dtype
    n_max: torch.Tensor  # () int32: most neighbors found within the cutoff


class ExclusionTables(NamedTuple):
    """Per-atom padded exclusion partner tables."""

    partner: torch.Tensor   # (N, K) int64, padded with -1
    scale_el: torch.Tensor  # (N, K) electrostatic scale at that partner
    scale_lj: torch.Tensor  # (N, K) LJ scale at that partner


def build_neighbor_list(positions: torch.Tensor, cutoff: float,
                        capacity: int) -> NeighborList:
    """Fixed-capacity neighbor list within ``cutoff`` (nm) of positions
    ``(N, 3)``, on their device.

    Lists both directions of every pair (i in j's list and j in i's), as
    the Born integral needs complete rows. Overflow saturates at the
    ``capacity`` nearest neighbors; ``n_max`` reports the largest count."""
    n = positions.shape[0]
    k = min(int(capacity), n)
    cutoff2 = cutoff * cutoff
    rows = max(1, min(n, _BUILD_CHUNK_ENTRIES // max(n, 1)))
    idx_parts, mask_parts, counts = [], [], []
    for s in range(0, n, rows):
        e = min(n, s + rows)
        diff = positions[s:e, None, :] - positions[None, :, :]
        d2 = (diff * diff).sum(-1)
        within = d2 < cutoff2
        within[torch.arange(e - s, device=positions.device),
               torch.arange(s, e, device=positions.device)] = False
        score = torch.where(within, -d2, torch.full_like(d2, -torch.inf))
        _, idx = torch.topk(score, k, dim=1)
        mask = within.gather(1, idx)
        # self-pad invalid slots so gathers stay in bounds and r != 0
        own = torch.arange(s, e, device=positions.device)[:, None]
        idx_parts.append(torch.where(mask, idx, own))
        mask_parts.append(mask)
        counts.append(within.sum(1))
    return NeighborList(
        idx=torch.cat(idx_parts),
        mask=torch.cat(mask_parts).to(positions.dtype),
        n_max=torch.cat(counts).max().to(torch.int32),
    )


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` along the first axis by ``index_select``, whose backward is
    an ``index_add_`` (advanced indexing's is an ``index_put_`` with
    accumulation, which sorts the indices on the card)."""
    return t.index_select(0, idx.reshape(-1)).reshape(idx.shape + t.shape[1:])


def _pair_r(positions: torch.Tensor, nl: NeighborList) -> torch.Tensor:
    """Pair distances with masked (self-padded) slots pushed 1 nm out:
    r ~ 0 there would overflow (sigma/r)^12 to inf and poison the masked
    sums with inf * 0 = NaN."""
    d = positions[:, None, :] - _take(positions, nl.idx)   # (N, M, 3)
    r = torch.sqrt((d * d).sum(-1) + _EPS)
    return r + (1.0 - nl.mask)


def _lj_coulomb_pair(system: System, r, i_idx, j_idx):
    """Full-strength LJ + Coulomb for index arrays of any shape."""
    sig = 0.5 * (system.lj_sigma[i_idx] + _take(system.lj_sigma, j_idx))
    eps = torch.sqrt(torch.clamp(system.lj_eps[i_idx] * _take(system.lj_eps, j_idx), min=0.0))
    inv_r = 1.0 / r
    sr6 = (sig * inv_r) ** 6
    e_lj = 4.0 * eps * (sr6 * sr6 - sr6)
    ke = COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 / system.solute_dielectric
    e_el = ke * system.charges[i_idx] * _take(system.charges, j_idx) * inv_r
    return e_lj, e_el


def _exclusion_table_arrays(excl12_idx, pair14_idx, n: int):
    """``(partner, scale_el, scale_lj)`` as host numpy: the loop of the JAX
    package's ``make_exclusion_tables``, copied."""
    per_atom: list = [[] for _ in range(n)]
    for i, j in np.asarray(excl12_idx):
        per_atom[int(i)].append((int(j), 0.0, 0.0))
        per_atom[int(j)].append((int(i), 0.0, 0.0))
    for i, j in np.asarray(pair14_idx):
        per_atom[int(i)].append((int(j), SCEE, SCNB))
        per_atom[int(j)].append((int(i), SCEE, SCNB))
    k = max((len(p) for p in per_atom), default=1)
    partner = np.full((n, k), -1, dtype=np.int32)
    s_el = np.ones((n, k), dtype=np.float32)
    s_lj = np.ones((n, k), dtype=np.float32)
    for i, entries in enumerate(per_atom):
        for slot, (j, se, sl) in enumerate(entries):
            partner[i, slot] = j
            s_el[i, slot] = se
            s_lj[i, slot] = sl
    return partner, s_el, s_lj


def make_exclusion_tables(system: System) -> ExclusionTables:
    """The per-atom tables from the System's exclusion pair lists, on the
    System's device (built on the host once, before the force path)."""
    if system.excl12_idx is None:
        raise ValueError(
            "system lacks exclusion index lists; rebuild it with the "
            "current md.forcefield.build_system"
        )
    partner, s_el, s_lj = _exclusion_table_arrays(
        system.excl12_idx.reshape(-1, 2).cpu().numpy(),
        system.pair14_idx.reshape(-1, 2).cpu().numpy(), system.n_atoms)
    dev = system.device
    return ExclusionTables(
        partner=torch.as_tensor(partner, dtype=torch.int64, device=dev),
        scale_el=torch.as_tensor(s_el, device=dev),
        scale_lj=torch.as_tensor(s_lj, device=dev),
    )


def _pair_scales(nl: NeighborList, tables: ExclusionTables,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each listed pair's electrostatic and LJ scale ``(N, M)`` from its
    row's exclusion table (unmatched pairs keep 1): 1 - sum over the
    table's slots of match * (1 - scale), one slot at a time, so no
    ``(N, M, K)`` tensor is held."""
    s_el = torch.zeros(nl.idx.shape, dtype=dtype, device=nl.idx.device)
    s_lj = torch.zeros_like(s_el)
    for k in range(tables.partner.shape[1]):
        match = (nl.idx == tables.partner[:, k:k + 1]).to(dtype)
        s_el = s_el + match * (1.0 - tables.scale_el[:, k:k + 1])
        s_lj = s_lj + match * (1.0 - tables.scale_lj[:, k:k + 1])
    return 1.0 - s_el, 1.0 - s_lj


def _nonbonded_scaled(system: System, positions: torch.Tensor, nl: NeighborList,
                      scales) -> torch.Tensor:
    r = _pair_r(positions, nl)
    i_idx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    e_lj, e_el = _lj_coulomb_pair(system, r, i_idx, nl.idx)
    s_el, s_lj = scales
    return 0.5 * ((e_lj * s_lj + e_el * s_el) * nl.mask).sum()


def nonbonded_energy_nb(system: System, positions: torch.Tensor, nl: NeighborList,
                        tables: ExclusionTables) -> torch.Tensor:
    """LJ + Coulomb over the neighbor list with in-place exclusion scaling."""
    return _nonbonded_scaled(system, positions, nl,
                             _pair_scales(nl, tables, positions.dtype))


def born_radii_nb(system: System, positions: torch.Tensor, nl: NeighborList) -> torch.Tensor:
    """HCT descreening integral (+ GBn2 neck) over the neighbor list."""
    r = _pair_r(positions, nl)
    rho = system.gb_radii - system.gb_offset
    term, inactive = _hct_pair_term(r, _take(system.gb_screen * rho, nl.idx), rho[:, None])
    active = (~inactive).to(positions.dtype) * nl.mask
    I = 0.5 * (term * active).sum(1)

    if system.gb_neck_scale != 0.0 and system.gb_neck_m0 is not None:
        i_idx = torch.arange(positions.shape[0], device=positions.device)[:, None]
        d0 = system.gb_neck_d0[i_idx, nl.idx]
        m0 = system.gb_neck_m0[i_idx, nl.idx]
        nv, _ = neck_value_and_derivative(r, d0, m0)
        I = I + system.gb_neck_scale * (nv * nl.mask).sum(1)
    return _born_rescale(system, I)


def gb_energy_nb(system: System, positions: torch.Tensor, nl: NeighborList) -> torch.Tensor:
    """GB polarization + ACE surface term with the cross term truncated at
    the list's cutoff (choose it >= 2 nm for GB accuracy, Amber rgbmax)."""
    B = born_radii_nb(system, positions, nl)
    f = _gb_f(_pair_r(positions, nl), B[:, None] * _take(B, nl.idx))
    qq = system.charges[:, None] * _take(system.charges, nl.idx)
    e_cross = _gb_prefactor(system) * (qq / f * nl.mask).sum()    # both directions
    e_self, e_sa = _gb_self_and_surface(system, B)
    return e_cross + e_self + e_sa


def _potential_scaled(system: System, positions: torch.Tensor, nl: NeighborList,
                      scales, bias_fn: Optional[Callable] = None) -> torch.Tensor:
    e = (bond_energy(system, positions) + angle_energy(system, positions)
         + torsion_energy(system, positions)
         + _nonbonded_scaled(system, positions, nl, scales))
    if system.use_gb:
        e = e + gb_energy_nb(system, positions, nl)
    if bias_fn is not None:
        e = e + bias_fn(positions)
    return e


def potential_energy_nb(
    system: System,
    positions: torch.Tensor,
    nl: NeighborList,
    tables: Optional[ExclusionTables] = None,
    bias_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Total potential with the nonbonded / GB stages on the neighbor list
    (the bonded terms are the dense path's, index-based already). Build
    ``tables`` (``make_exclusion_tables``) once for repeated calls."""
    if tables is None:
        tables = make_exclusion_tables(system)
    return _potential_scaled(system, positions, nl,
                             _pair_scales(nl, tables, positions.dtype), bias_fn)


def _energy_and_forces(system: System, x: torch.Tensor, nl: NeighborList, scales,
                       bias_fn: Optional[Callable]):
    """``(energy, forces)`` of ``_potential_scaled``, forces by autograd."""
    with torch.enable_grad():
        y = x.detach().requires_grad_(True)
        e = _potential_scaled(system, y, nl, scales, bias_fn)
        (g,) = torch.autograd.grad(e, y)
    return e.detach(), -g


def _default_capacity(n_atoms: int, cutoff: float, skin: float) -> int:
    """``run_md_nb``'s capacity: a conservative ~100 atoms/nm^3 protein
    interior estimate, at most N - 1."""
    return min(n_atoms - 1, max(64, int(120 * (cutoff + skin) ** 3)))


def run_md_nb(
    system: System,
    state,
    *,
    n_steps: int,
    dt: float,
    friction: float,
    temperature_K,
    report_interval: int = 100,
    cutoff: float = 2.0,
    skin: float = 0.2,
    capacity: Optional[int] = None,
    rebuild_interval: int = 20,
    bias_fn: Optional[Callable] = None,
):
    """Neighbor-listed analogue of ``md.integrate.run_md`` for one system,
    ``state.positions (N, 3)``.

    Every ``rebuild_interval`` steps the list is rebuilt at ``cutoff +
    skin``; the Langevin steps in between run against the frozen list.
    Returns ``(final_state, frames)``: ``positions (F, N, 3)``,
    ``potential_energy (F,)`` (the last step's, at its pre-step positions)
    and ``temperature (F,)`` (of the state's velocities), one frame every
    ``report_interval`` steps, as JAX's ``run_md_nb`` reports."""
    from .integrate import instantaneous_temperature, langevin_step

    if report_interval % rebuild_interval != 0:
        raise ValueError("rebuild_interval must divide report_interval")
    if n_steps % report_interval != 0:
        raise ValueError("report_interval must divide n_steps")
    if state.positions.dim() != 2:
        raise ValueError(f"run_md_nb integrates one system, positions (N, 3); got "
                         f"{tuple(state.positions.shape)}")
    if capacity is None:
        capacity = _default_capacity(system.n_atoms, cutoff, skin)
    tables = make_exclusion_tables(system)
    positions, energies, temps = [], [], []
    for _ in range(n_steps // report_interval):
        for _ in range(report_interval // rebuild_interval):
            nl = build_neighbor_list(state.positions, cutoff + skin, capacity)
            scales = _pair_scales(nl, tables, state.positions.dtype)

            def force_fn(x, nl=nl, scales=scales):
                return _energy_and_forces(system, x, nl, scales, bias_fn)

            for _ in range(rebuild_interval):
                state, energy = langevin_step(
                    system, state, dt=dt, friction=friction,
                    temperature_K=temperature_K, force_fn=force_fn)
        positions.append(state.positions)
        energies.append(energy)
        temps.append(instantaneous_temperature(system, state.velocities))
    return state, {
        "positions": torch.stack(positions),
        "potential_energy": torch.stack(energies),
        "temperature": torch.stack(temps),
    }


__all__ = [
    "NeighborList", "ExclusionTables", "build_neighbor_list",
    "make_exclusion_tables", "nonbonded_energy_nb", "born_radii_nb",
    "gb_energy_nb", "potential_energy_nb", "run_md_nb",
]
