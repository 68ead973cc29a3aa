"""Index-band exclusions and the cell decomposition of a periodic box.

Port of ``pmarlo_tpu/md/cells.py``.

**Exclusions** (``_scaled_pair_list``, ``exclusion_band_width``,
``banded_scales``: numpy, the same arithmetic). The pair kernels
(``md/pair_force.py``), the periodic kernel (``md/periodic_force.py``) and
the cell-list kernel (``md/cell_force.py``) mask every LJ/Coulomb pair
whose atom indices differ by at most the band width D, and the band is
added back in plain PyTorch at its wanted (scaled) value: excluded pairs
then contribute an exact zero instead of a large kernel term minus a large
correction. Scaled pairs farther apart in index than D (disulfides) go to a
sparse far list, corrected by subtraction at their moderate distances.
``ExclusionBand`` carries these arrays; ``ExclusionBand.from_numpy`` takes
the JAX package's own arrays.

**Cells** (``CellGrid``, ``make_cell_grid``, ``bin_atoms``,
``NeighborState``, ``free_skin``). Atoms are binned into a grid whose cell
layers are at least one cutoff thick, so the 27-cell neighbourhood covers
every pair within the cutoff. The port's cell sweep does not use the TPU
layout: ``bin_atoms`` returns a stable sort of the atoms by cell id and CSR
offsets (``cell_start``), which hold any occupancy, so no cell can
overflow.

**The TPU slot layout** (``C_FEAT``, ``cell_slots``, ``scatter_features``,
``ghost_pad``, ``make_cell_grid(lane_align=True)``, ``CellGrid.n_slots``):
the helpers that feed JAX's cell kernel, in plain PyTorch with JAX's
results. ``cell_slots`` turns ``bin_atoms``' sort into JAX's per-atom
slots; ``scatter_features`` fills a ``(C_FEAT, n_cells * capacity)``
feature array of fixed-capacity cell slots, and ``ghost_pad`` its copy
wrap-padded by one cell a face with the coordinates of
the wrapped layers shifted by a lattice vector. No step path of the port
calls them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import host_constant
from .ff_params import SCEE, SCNB

C_FEAT = 8  # x, y, z, charge, sigma, eps, mask, atom index


def _np(a) -> np.ndarray:
    """Host numpy view of a torch tensor or any array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _scaled_pair_list(system) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(idx (P, 2) i<j, se (P,), sl (P,)) for every pair with a scale
    below 1, built from the sparse exclusion lists (no (N, N) matrix)."""
    parts_idx, parts_se, parts_sl = [], [], []
    e12 = _np(system.excl12_idx).reshape(-1, 2)
    if e12.size:
        e12 = np.sort(e12, axis=1)
        parts_idx.append(e12)
        parts_se.append(np.zeros(e12.shape[0], np.float32))
        parts_sl.append(np.zeros(e12.shape[0], np.float32))
    p14 = _np(system.pair14_idx).reshape(-1, 2)
    if p14.size:
        p14 = np.sort(p14, axis=1)
        parts_idx.append(p14)
        parts_se.append(np.full(p14.shape[0], SCEE, np.float32))
        parts_sl.append(np.full(p14.shape[0], SCNB, np.float32))
    if not parts_idx:
        return (np.zeros((0, 2), np.int32), np.zeros(0, np.float32),
                np.zeros(0, np.float32))
    idx = np.concatenate(parts_idx).astype(np.int32)
    se = np.concatenate(parts_se)
    sl = np.concatenate(parts_sl)
    # dedupe (1-4 lists never overlap 1-2/1-3 by construction, but be safe)
    key = idx[:, 0].astype(np.int64) * (idx.max() + 1) + idx[:, 1]
    _, first = np.unique(key, return_index=True)
    return idx[first], se[first], sl[first]


def exclusion_band_width(system, cap: int = 64) -> int:
    """Smallest D covering the scaled/excluded pairs by index distance,
    capped at ``cap`` (pairs beyond it go to the sparse far list)."""
    idx, _, _ = _scaled_pair_list(system)
    if idx.shape[0] == 0:
        return 1
    dist = idx[:, 1] - idx[:, 0]
    return int(min(int(dist.max()), cap))


def banded_scales(
    system, D: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(band_se (N, D), band_sl (N, D), far_idx (P, 2), far_se, far_sl):
    band_se[i, k-1] is the scale of pair (i, i+k) (1.0 when unscaled or
    past the end); the far list holds scaled pairs with index distance
    > D. O(N*D) memory."""
    idx, se, sl = _scaled_pair_list(system)
    n = system.n_atoms
    band_se = np.ones((n, D), np.float32)
    band_sl = np.ones((n, D), np.float32)
    dist = idx[:, 1] - idx[:, 0] if idx.size else np.zeros(0, np.int64)
    near = dist <= D
    if idx.size:
        band_se[idx[near, 0], dist[near] - 1] = se[near]
        band_sl[idx[near, 0], dist[near] - 1] = sl[near]
    far_idx = idx[~near] if idx.size else np.zeros((0, 2), np.int32)
    far_se = se[~near] if idx.size else np.zeros(0, np.float32)
    far_sl = sl[~near] if idx.size else np.zeros(0, np.float32)
    return band_se, band_sl, far_idx.astype(np.int32), far_se, far_sl


@dataclasses.dataclass(frozen=True)
class ExclusionBand:
    """The band width and the arrays of ``banded_scales``."""

    width: int                 # D: pairs with |i - j| <= D are masked
    band_se: np.ndarray        # (N, D) Coulomb scale of pair (i, i+k)
    band_sl: np.ndarray        # (N, D) LJ scale of pair (i, i+k)
    far_idx: np.ndarray        # (P, 2) scaled pairs beyond the band
    far_se: np.ndarray         # (P,)
    far_sl: np.ndarray         # (P,)

    @classmethod
    def from_system(cls, system, width: "int | None" = None) -> "ExclusionBand":
        D = exclusion_band_width(system) if width is None else int(width)
        return cls(D, *banded_scales(system, D))

    @classmethod
    def from_numpy(cls, width, band_se, band_sl, far_idx, far_se,
                   far_sl) -> "ExclusionBand":
        """From the JAX package's ``exclusion_band_width`` and
        ``banded_scales`` outputs."""
        return cls(
            int(width), np.asarray(band_se, np.float32),
            np.asarray(band_sl, np.float32),
            np.asarray(far_idx, np.int32).reshape(-1, 2),
            np.asarray(far_se, np.float32), np.asarray(far_sl, np.float32),
        )

    def correction_pairs(self):
        """(i, j, c_el, c_lj) for the add-back pass: every band pair at
        its wanted scale, then every far pair at (scale - 1), which turns
        the kernel's full-strength term into the wanted one. Pairs whose
        two coefficients are both zero (the excluded band pairs) add
        nothing and are left out."""
        n, D = self.band_se.shape
        i = np.repeat(np.arange(n), D)
        k = np.tile(np.arange(1, D + 1), n)
        inside = i + k < n
        i, j = i[inside], (i + k)[inside]
        c_el = self.band_se.reshape(-1)[inside].astype(np.float64)
        c_lj = self.band_sl.reshape(-1)[inside].astype(np.float64)
        i = np.concatenate([i, self.far_idx[:, 0]])
        j = np.concatenate([j, self.far_idx[:, 1]])
        c_el = np.concatenate([c_el, self.far_se.astype(np.float64) - 1.0])
        c_lj = np.concatenate([c_lj, self.far_sl.astype(np.float64) - 1.0])
        keep = (c_el != 0.0) | (c_lj != 0.0)
        return i[keep], j[keep], c_el[keep], c_lj[keep]


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static geometry of the cell decomposition."""

    box: Tuple[float, float, float]
    cutoff: float
    nx: int
    ny: int
    nz: int
    #: mean occupancy with margin, as the JAX grid sizes its slot arrays; the
    #: port's kernel takes any occupancy and reads no capacity
    capacity: int
    #: triclinic off-diagonals (bx, cx, cy), ``md/box.py`` reduced form;
    #: None -> orthorhombic. Cells are then parallelepipeds binned in
    #: fractional coordinates.
    tilt: Optional[Tuple[float, float, float]] = None

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def n_slots(self) -> int:
        return self.n_cells * self.capacity

    @property
    def cell_size(self) -> Tuple[float, float, float]:
        """Per-axis slab thickness bounding the neighbourhood cover: the
        edge length for orthorhombic grids, the perpendicular width per
        cell layer for triclinic ones."""
        if self.tilt is None:
            return (self.box[0] / self.nx, self.box[1] / self.ny,
                    self.box[2] / self.nz)
        from .box import box_matrix, perp_widths

        pw = perp_widths(box_matrix(self.box, self.tilt))
        return (float(pw[0]) / self.nx, float(pw[1]) / self.ny,
                float(pw[2]) / self.nz)

    def matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(H, Hinv) as float64 numpy."""
        from .box import box_matrix

        H = box_matrix(self.box, self.tilt)
        return H, np.linalg.inv(H)


def make_cell_grid(
    box: Tuple[float, float, float],
    cutoff: float,
    n_atoms: int,
    *,
    occupancy_margin: float = 1.4,
    min_headroom: int = 8,
    lane_align: bool = False,
    tilt: Optional[Tuple[float, float, float]] = None,
) -> CellGrid:
    """Choose the grid: the most cells with a layer at least ``cutoff``
    thick per axis; ``capacity`` from the mean occupancy with margin,
    rounded up to a multiple of 8, or of 128 with ``lane_align`` (the TPU
    kernel's slot runs; the port's sweep reads no capacity)."""
    if tilt is None:
        widths = np.asarray(box, np.float64)
    else:
        from .box import box_matrix, perp_widths, validate_reduced

        H = box_matrix(box, tilt)
        validate_reduced(H)
        # the cover condition bounds the perpendicular slab width per
        # cell layer, not the (longer) edge length
        widths = perp_widths(H)
    nx = max(int(np.floor(widths[0] / cutoff)), 1)
    ny = max(int(np.floor(widths[1] / cutoff)), 1)
    nz = max(int(np.floor(widths[2] / cutoff)), 1)
    mean_occ = n_atoms / float(nx * ny * nz)
    cap = int(np.ceil(occupancy_margin * mean_occ)) + min_headroom
    align = 128 if lane_align else 8
    cap = ((cap + align - 1) // align) * align
    return CellGrid(box=tuple(float(b) for b in box), cutoff=float(cutoff),
                    nx=int(nx), ny=int(ny), nz=int(nz), capacity=int(cap),
                    tilt=(tuple(float(t) for t in tilt)
                          if tilt is not None else None))


def free_skin(grid: CellGrid) -> float:
    """Slack between the thinnest cell layer and the cutoff: the skin the
    grid supports with no extra kernel work."""
    return float(min(grid.cell_size) - grid.cutoff)


def bin_atoms(grid: CellGrid, x: torch.Tensor, box: Optional[torch.Tensor] = None):
    """Assign atoms to cells and sort them by cell.

    ``x`` is ``(..., N, 3)``; every leading index (a replica) is binned on
    its own. ``box``, a (3,) tensor, replaces the grid's diagonal on the
    device (the NPT path: the cell counts stay, the cells scale with the
    box; a triclinic grid keeps its tilt ratios). Returns ``(order,
    cell_start, cell_id, xw)``:

    - ``cell_id (..., N)`` int64: each atom's flat cell index
      ``(cx * ny + cy) * nz + cz``, as the JAX ``bin_atoms`` computes it;
    - ``order (..., N)`` int32: atom indices sorted by cell, ascending atom
      index within a cell (a stable sort), so a cell's summation order is
      fixed;
    - ``cell_start (..., n_cells + 1)`` int32: CSR offsets into ``order``;
    - ``xw (..., N, 3)``: the positions wrapped into the primary cell, the
      coordinates the kernel works on (with lattice shifts for neighbour
      cells across a face, it needs no minimum-image arithmetic)."""
    ncell = host_constant((grid.nx, grid.ny, grid.nz), x)
    if grid.tilt is None:
        box = (host_constant(grid.box, x) if box is None
               else torch.as_tensor(box, dtype=x.dtype, device=x.device))
        xw = x - torch.floor(x / box) * box
        f = xw / box
    else:
        from .box import latmul, tilt_ratios, traced_matrices

        if box is None:
            H_np, Hinv_np = grid.matrices()
            H = torch.as_tensor(H_np, dtype=x.dtype, device=x.device)
            Hinv = torch.as_tensor(Hinv_np, dtype=x.dtype, device=x.device)
        else:
            H, Hinv = traced_matrices(box.to(x.dtype), tilt_ratios(grid.box, grid.tilt))
        f = latmul(x, Hinv)
        f = f - torch.floor(f)
        xw = latmul(f, H)
    c = (f * ncell).to(torch.int64)
    cx = c[..., 0].clamp(0, grid.nx - 1)
    cy = c[..., 1].clamp(0, grid.ny - 1)
    cz = c[..., 2].clamp(0, grid.nz - 1)
    cid = (cx * grid.ny + cy) * grid.nz + cz
    cid_sorted, order = torch.sort(cid, dim=-1, stable=True)
    edges = torch.arange(grid.n_cells + 1, device=x.device).expand(
        cid.shape[:-1] + (grid.n_cells + 1,)).contiguous()
    cell_start = torch.searchsorted(cid_sorted, edges)
    return order.to(torch.int32), cell_start.to(torch.int32), cid, xw


def cell_slots(grid: CellGrid, order: torch.Tensor, cell_start: torch.Tensor,
               cell_id: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each atom's flat slot in the ``(n_cells * capacity)`` slot space
    from ``bin_atoms``' sort, ``(slot (..., N) int64, overflow)``: slot =
    cell * capacity + the atom's rank in its cell (ascending atom index),
    as JAX's ``bin_atoms`` assigns them. ``overflow`` (a bool tensor) is
    True when a cell holds more than ``capacity`` atoms; the excess ranks
    then clamp onto the cell's last slot, as in JAX. This is the slot
    layout ``scatter_features`` and ``ghost_pad`` take; the port's sweep
    reads ``order`` and ``cell_start`` instead."""
    order = order.long()
    n = order.shape[-1]
    pos = torch.arange(n, device=order.device).expand(order.shape)
    start = cell_start.long().gather(-1, cell_id.gather(-1, order))
    rank = torch.empty_like(order).scatter_(-1, order, pos - start)
    overflow = (rank >= grid.capacity).any()
    return cell_id * grid.capacity + rank.clamp(max=grid.capacity - 1), overflow


def scatter_features(
    grid: CellGrid,
    xw: torch.Tensor,
    slot: torch.Tensor,
    charges: torch.Tensor,
    sigma: torch.Tensor,
    eps: torch.Tensor,
) -> torch.Tensor:
    """Per-atom features in the ``(C_FEAT, n_slots)`` slot array, on the
    device of ``xw (N, 3)`` (wrapped coordinates) and ``slot (N,)`` (each
    atom's flat slot, from ``cell_slots``, as JAX's ``bin_atoms`` assigns
    them). Empty slots
    carry mask 0, atom index -1e6 (never within the exclusion band of a
    real index) and coordinates 100 box lengths away, so no distance to
    them falls under a cutoff. Two atoms clamped onto one slot (a cell
    overflow) leave that slot unspecified, as in JAX."""
    n = xw.shape[0]
    dt = xw.dtype
    feat = torch.stack([
        xw[:, 0], xw[:, 1], xw[:, 2], charges.to(dt), sigma.to(dt), eps.to(dt),
        torch.ones(n, dtype=dt, device=xw.device),
        torch.arange(n, dtype=dt, device=xw.device),
    ], dim=1)                                               # (N, C)
    slots = torch.zeros((grid.n_slots, C_FEAT), dtype=dt, device=xw.device)
    slots[:, 0] = -100.0 * grid.box[0]
    slots[:, 7] = -1e6
    slots[slot.long()] = feat
    return slots.T                                          # (C, S)


def _wrap_pad(g: torch.Tensor, dim: int) -> torch.Tensor:
    """One layer of periodic padding on each side of ``dim``."""
    n = g.shape[dim]
    return torch.cat([g.narrow(dim, n - 1, 1), g, g.narrow(dim, 0, 1)], dim=dim)


def ghost_pad(grid: CellGrid, slots: torch.Tensor,
              box: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Wrap-pad the slot array ``(C, n_slots)`` by one cell a face, the
    coordinate channels of each wrapped layer shifted by the lattice vector
    of the face it crossed, so that plain distances need no minimum image.

    Returns ``(C, (nx + 2)(ny + 2)(nz + 2) capacity)``, z fastest, then the
    slot. ``box`` (a (3,) tensor) replaces the grid's diagonal (the NPT
    path); a triclinic grid's tilt then follows it by the grid's tilt
    ratios."""
    C = slots.shape[0]
    g = slots.reshape(C, grid.nx, grid.ny, grid.nz, grid.capacity)
    for dim in (1, 2, 3):
        g = _wrap_pad(g, dim)
    if box is None:
        bx, by, bz = grid.box
    else:
        bx, by, bz = box[0], box[1], box[2]
    # a corner ghost sits in several boundary layers and takes each crossed
    # lattice vector: a = (ax, 0, 0), b = (tbx, by, 0), c = (tcx, tcy, cz)
    if grid.tilt is None:
        tbx = tcx = tcy = 0.0
    elif box is None:
        tbx, tcx, tcy = grid.tilt
    else:
        from .box import tilt_ratios

        rbx, rcx, rcy = tilt_ratios(grid.box, grid.tilt)
        tbx, tcx, tcy = rbx * bx, rcx * bx, rcy * by
    g[0, 0] -= bx
    g[0, -1] += bx
    g[1, :, 0] -= by
    g[1, :, -1] += by
    g[2, :, :, 0] -= bz
    g[2, :, :, -1] += bz
    if grid.tilt is not None:
        g[0, :, 0] -= tbx          # b-vector x component
        g[0, :, -1] += tbx
        g[0, :, :, 0] -= tcx       # c-vector x component
        g[0, :, :, -1] += tcx
        g[1, :, :, 0] -= tcy       # c-vector y component
        g[1, :, :, -1] += tcy
    return g.reshape(C, -1)


@dataclasses.dataclass(frozen=True)
class NeighborState:
    """A cell assignment: what ``bin_atoms`` found, as the cell-list sweep
    takes it. ``xw`` are the coordinates the sweep works on. They need not
    stay inside the primary cell: an assignment holds for any ``xw`` that
    keeps every pair within the cutoff inside its 27-cell neighbourhoods
    (each atom within ``free_skin(grid) / 2`` of where it was binned), moved
    by raw displacement with no re-wrap, so that an atom drifting across the
    boundary stays consistent with its binned cell and the lattice shifts."""

    order: torch.Tensor       # (..., N) int32 atoms sorted by cell
    cell_start: torch.Tensor  # (..., n_cells + 1) int32 CSR offsets
    xw: torch.Tensor          # (..., N, 3) the coordinates swept


__all__ = [
    "C_FEAT", "CellGrid", "ExclusionBand", "NeighborState", "banded_scales", "bin_atoms",
    "cell_slots", "exclusion_band_width", "free_skin", "ghost_pad", "make_cell_grid",
    "scatter_features",
]
