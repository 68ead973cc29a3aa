"""Explicit-solvent forces in O(N): the cell-list sweep as a CUDA kernel
with its plain PyTorch twin.

Port of ``pmarlo_tpu/md/pallas_cells.py build_cell_force_fn``: the same
physics as the dense sweep (``md/periodic_force.py``: shifted or switched
LJ, reaction-field Coulomb, OpenMM CutoffPeriodic semantics, 1-4 pairs as
uncut scaled Coulomb), orthorhombic or triclinic, evaluated over the cells'
neighbourhoods. A force evaluation is

1. binning (``cells.bin_atoms``): wrapped coordinates, a stable sort of
   the atoms by cell and CSR offsets. No slot array, no capacity and no
   ghost copies: any occupancy fits, so nothing can overflow;
2. the sweep (``csrc/cell_force.cu`` on CUDA tensors, ``sweep_reference``
   on CPU tensors: a CUDA tensor launches the kernel or raises) over the
   half shell: for every cell its own pairs (column after row in sorted
   order) and its atoms against the 13 forward neighbour cells
   (``HALF_SHELL``), each displaced by the lattice vector of the faces it
   is reached across, so each unordered image pair within the cutoff is
   taken once, from one side, ``xi - (xj + shift)``; the index band
   ``|i - j| <= D`` masked; half of each pair's energy to each atom's row.
   The kernel gives a warp a (cell, direction, row group) item, walks its
   32 x 32 patches, compacts the pairs inside the cutoff onto full warps
   before the pair term, and writes its sums to per-atom slots
   (``cell_scratch``: 56 slots of 16 bytes and a packed copy of the atoms,
   928 bytes an atom, 25.8 MB on the 27,783-atom water box at R = 1; refused
   past a quarter of the card's memory), which a second kernel adds in slot
   order, so two launches give the same bits. It is bound by instructions:
   every candidate's r^2 and the pair term of the ~13% inside the cutoff;
3. the band add-back and far-pair correction from the pair lists
   (``periodic_force.PairListCorrection``), the bonded terms
   (``md/analytic.py``) and, if asked for, the dispersion tail 2 pi C / V.

**Binning policy.** Every evaluation bins afresh: the sort and the offsets
are a few device operations and nothing is read back to the host. The
stateful entries ``init_state`` / ``apply`` (and ``_batched``) keep the
signatures of the JAX package's, whose carry lets it skip the sort while no
atom has moved more than half the grid's slack (``cells.free_skin``); on a
card that test is a host read a call, and on the 27,783-atom water box it
fails every second step, so it saves nothing measurable (PERF.md). Here the
carry is the binning of the call that returned it, and ``evaluate`` sweeps
any binning it is given. The physics does not depend on when the sort
happens, only the summation order does.

**Smooth PME** (``electrostatics="pme"``). The kernel's real-space Ewald
mode (``erfcf`` and its exact derivative, shifted to zero at the cutoff
unless ``ewald_shift=False``) takes the pairs inside the cutoff; the
reciprocal sum, the self and the background terms come from ``md/pme.py``
(a ``ReciprocalMesh`` built once: order-6 splines on the mesh that JAX
chooses), its forces by autograd; the pair-list correction takes the erf
part off every scaled pair.

**A box that changes** (``dynamic`` / ``init_state_dynamic`` /
``apply_dynamic``, the NPT path of ``md/barostat.py``). The cell counts stay
as built; the box is a (3,) float32 tensor argument, and what derives from
it follows on the device: the 27 lattice shifts the kernel reads, the wrap
of ``bin_atoms``, the minimum image of the correction, the dispersion tail
2 pi C / V and the PME influence function. A triclinic cell keeps its tilt
ratios. Where the box has shrunk a cell layer below the cutoff, the
27-cell neighbourhoods no longer cover every pair: the energy and forces
are NaN then (as JAX poisons them), computed on the device, so a volume
move into such a box is rejected without a host read.

Pair arithmetic in the kernel is float32; energy rows are summed in float64
past a patch and the plain twin evaluates in float64 outright. Energies
come back as float32. ``launches`` counts kernel launches.

**x-slabs** (``mesh=``, a 1-D ``DeviceMesh`` of n ranks; JAX's spatial
decomposition). Every rank bins all atoms, as JAX keeps the atom-major
arrays replicated; rank r's home cells are the x-layers ``[r cxl, (r + 1)
cxl)``, ``cxl = nx / n``. Its launch (``pmarlo_cell_force_slab``) takes
only the atoms of its extended slab, the interior and one halo layer on
the +x face (the half shell's dx is 0 or +1), the last rank's halo being
layer 0 across the +x face; the kernel's scratch is sized to that slab
(``local_shapes``, ``scratch_bytes``). A pair whose partner is a halo atom
credits that atom's global row, and one ``all_reduce`` of the energy and
of the per-atom forces joins the ranks: each home cell lies in one slab,
so each pair is counted once. What is not a pair sweep (the band add-back
and far exclusions, the bonded terms, PME's reciprocal term, the
dispersion tail) is computed on the first rank alone and added before the
sum, and every rank spreads its own part onto the virtual sites' parents
before it: nothing is added after the sum, so every rank holds the same
bits and the ranks' copies of the state stay in step over a run.
``sweep_reference`` takes the same home cells on the CPU. Finding the
slab's atoms reads four CSR offsets a replica back to the host.

**Virtual sites** (TIP4P-Ew, TIP5P water; ``md/vsites.py``): every entry
point re-derives the site rows from their parents before it bins and
spreads the site forces onto the parents after the evaluation. The kernel
sees the sites as atoms with charge and no LJ; the water's 6 (4-site) or
10 (5-site) intra-molecular pairs are excluded through the band.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from .. import _kernels
from ..constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
from .analytic import bonded_energy_and_forces, make_bonded_params
from .cells import (
    CellGrid,
    ExclusionBand,
    NeighborState,
    bin_atoms,
    make_cell_grid,
)
from .periodic_force import (
    PairListCorrection,
    PairPhysics,
    atom_rows,
    cutoff_mask,
    pair_terms,
    refuse_scratch,
)
from .pme import ReciprocalMesh
from .system import System
from .vsites import VirtualSites

#: kernel launches made by this process (chip_smoke.py resets and reads it):
#: the whole grid's, and a rank's x-slab's
launches = {"cell_force": 0, "cell_force_slab": 0}

#: the offsets of the half shell, rows of ``_neighbor_tables``' 27: the own
#: cell (13, offset (0, 0, 0)) and the 13 after it, (k // 9 - 1, (k // 3) % 3
#: - 1, k % 3 - 1) for k = 14..26; offset k's opposite is 26 - k
HALF_SHELL = tuple(range(13, 27))
#: work items of a (cell, direction): split s takes row groups s, s + 3, ...
CELL_SPLITS = 3
#: per-atom slots of the kernel's scratch: for each direction of the half
#: shell a row slot and a column slot a split
CELL_SLOTS = len(HALF_SHELL) * (1 + CELL_SPLITS)

_configured = False


def _library() -> ctypes.CDLL:
    global _configured
    lib = _kernels.library()
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pmarlo_cell_force.argtypes = [p, p, p, p, i, i, p, i, p, p, i, p, p, p, p]
        lib.pmarlo_cell_force.restype = i
        lib.pmarlo_cell_force_slab.argtypes = [p, p, p, p, i, i, p, i, i, i, p, p, i, p, p, p, p]
        lib.pmarlo_cell_force_slab.restype = i
        _configured = True
    return lib


def _neighbor_tables(grid: CellGrid):
    """The 27-cell neighbourhood: ``shifts (27, 3)`` float32, the lattice
    shift ``wx a + wy b + wz c`` of a neighbour reached across faces, indexed
    ``(wx + 1) 9 + (wy + 1) 3 + (wz + 1)``; and for each of the 27 offsets
    and each cell the neighbour's flat index ``nb (27, C)`` and its row of
    ``shifts`` ``wrap (27, C)`` (``csrc/cell_force.cu`` derives both in the
    kernel)."""
    H, _ = grid.matrices()
    w = np.array(list(np.ndindex(3, 3, 3))) - 1
    shifts = (w @ H).astype(np.float32)
    cells = np.arange(grid.n_cells)
    cz = cells % grid.nz
    cy = (cells // grid.nz) % grid.ny
    cx = cells // (grid.nz * grid.ny)
    nb = np.empty((27, grid.n_cells), np.int64)
    wrap = np.empty((27, grid.n_cells), np.int64)
    for k in range(27):
        off = (k // 9 - 1, (k // 3) % 3 - 1, k % 3 - 1)
        wrapped, wraps = [], []
        for c, o, n in zip((cx, cy, cz), off, (grid.nx, grid.ny, grid.nz)):
            t = c + o
            wraps.append(np.where(t < 0, -1, np.where(t >= n, 1, 0)))
            wrapped.append(t % n)
        nb[k] = (wrapped[0] * grid.ny + wrapped[1]) * grid.nz + wrapped[2]
        wrap[k] = (wraps[0] + 1) * 9 + (wraps[1] + 1) * 3 + (wraps[2] + 1)
    return shifts, nb, wrap


class Slab:
    """Rank ``rank``'s x-slab of a grid split over ``n_ranks``: home cells
    ``[lo, hi)`` (flat indices; x-major, so a slab is a range), its ``cxl``
    layers, and the halo layer ``halo`` (``wraps``: reached across the +x
    face, the last rank's)."""

    def __init__(self, grid: CellGrid, mesh):
        self.mesh = mesh
        self.n_ranks = mesh.size()
        self.rank = mesh.get_local_rank()
        self.cxl = grid.nx // self.n_ranks
        self.nyz = grid.ny * grid.nz
        x0 = self.rank * self.cxl
        self.lo, self.hi = x0 * self.nyz, (x0 + self.cxl) * self.nyz
        self.halo = (x0 + self.cxl) % grid.nx
        self.wraps = x0 + self.cxl == grid.nx
        self.dims = (ctypes.c_int * 3)(self.cxl + 1, grid.ny, grid.nz)

    def atoms(self, order: torch.Tensor, cell_start: torch.Tensor):
        """One replica's slab: the global atom index of each of its sorted
        positions (interior, then halo) and its CSR offsets on the slab
        grid, int32."""
        h0, h1 = self.halo * self.nyz, (self.halo + 1) * self.nyz
        a0, a1, b0, b1 = cell_start[[self.lo, self.hi, h0, h1]].tolist()
        local = torch.cat([order[a0:a1], order[b0:b1]])
        cs = torch.cat([cell_start[self.lo:self.hi] - a0,
                        cell_start[h0:h1 + 1] - b0 + (a1 - a0)])
        return local.to(torch.int32).contiguous(), cs.to(torch.int32).contiguous()


class CellForce:
    """``fn(x) -> (energy, forces)`` for the full periodic potential of
    ``system`` through the cell list: ``x`` is ``(N, 3)`` or ``(R, N, 3)``
    (every replica is binned on its own); energies come back with the
    leading shape. Built by ``build_cell_force_fn``; with ``mesh`` each
    rank sweeps its x-slab (module docstring)."""

    #: every entry point handles the system's virtual sites itself
    expands_vsites = True

    def __init__(self, system: System, grid: CellGrid, phys: PairPhysics, *,
                 band: Optional[ExclusionBand] = None, dispersion_correction: bool = False,
                 cell_chunk: int = 64, pme_mesh: Optional[ReciprocalMesh] = None,
                 pme_precise: bool = False, mesh=None):
        """``pme_mesh`` adds the reciprocal, self and background terms of
        smooth PME to an Ewald-mode ``phys`` (without it the Ewald mode
        evaluates the real-space sum alone)."""
        self.system = system
        self.grid = grid
        self.phys = phys
        self.electrostatics = "pme" if phys.ewald else "rf"
        self.cell_chunk = int(cell_chunk)
        self._atom_p = atom_rows(system)
        self.band = band if band is not None else ExclusionBand.from_system(system)
        if self.band.band_se.shape[0] != system.n_atoms:
            raise ValueError("exclusion band built for another system")
        self.band_D = int(self.band.width)
        self.correction = PairListCorrection(system, self.band, phys)
        self._bonded = make_bonded_params(system)
        self.vsites = VirtualSites.from_system(system)
        self._disp_2pi_c = 0.0
        self.e_dispersion = 0.0
        if dispersion_correction:
            from .dispersion import dispersion_coefficient

            self._disp_2pi_c = 2.0 * math.pi * dispersion_coefficient(system)
            self.e_dispersion = self._disp_2pi_c / float(np.prod(system.box))
        self._dims = (ctypes.c_int * 3)(grid.nx, grid.ny, grid.nz)
        shifts, nb, wrap = _neighbor_tables(grid)
        dev = system.device
        self._shifts = torch.as_tensor(shifts, device=dev).contiguous()
        self._nb = torch.as_tensor(nb, device=dev)
        self._wrap = torch.as_tensor(wrap, device=dev)
        # the box-dependent parts of a box tensor: the shifts' lattice
        # offsets and the cell counts
        self._offsets = torch.as_tensor(np.array(list(np.ndindex(3, 3, 3))) - 1,
                                        dtype=torch.float32, device=dev)
        self._ncell = torch.tensor([grid.nx, grid.ny, grid.nz], dtype=torch.float32, device=dev)
        self._ratios = None
        if grid.tilt is not None:
            from .box import tilt_ratios

            self._ratios = tilt_ratios(grid.box, grid.tilt)
        self.mesh = pme_mesh
        self.pme_precise = bool(pme_precise)
        self.slab = None if mesh is None else Slab(grid, mesh)
        #: per-rank cell counts of the slab (JAX's ``local_shapes``); None unsharded
        self.local_shapes = None if self.slab is None else {
            "home_cells": self.slab.hi - self.slab.lo,
            "slab_cells": (self.slab.cxl + 1) * self.slab.nyz,
        }
        if pme_mesh is not None:
            if not phys.ewald:
                raise ValueError("a PME mesh needs the sweep's Ewald mode")
            if pme_mesh.device != dev:
                raise ValueError("the PME mesh was built for another device")
            self.pme_order = pme_mesh.order
            self.pme_mesh_shape = pme_mesh.shape
            self._q = system.charges.float().contiguous()
            q64 = system.charges.double().cpu().numpy()
            ke = COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
            self.e_self = -ke * phys.alpha / math.sqrt(math.pi) * float((q64 * q64).sum())
            #: background numerator: the term is this over the volume
            self._background_v = (-ke * math.pi / (2.0 * phys.alpha**2)
                                  * float(q64.sum()) ** 2)

    # --- shapes and state ---------------------------------------------------------

    def _batch(self, x: torch.Tensor) -> torch.Tensor:
        n = self.system.n_atoms
        if x.dim() != 3 or tuple(x.shape[1:]) != (n, 3):
            raise ValueError(f"x must be (R, {n}, 3), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError("x must be float32")
        if x.device != self.system.device:
            raise ValueError(f"x on {x.device} but the cell force was built "
                             f"for {self.system.device}")
        return x

    def _expand(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.vsites is None else self.vsites.expand(x)

    def _spread(self, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return f if self.vsites is None else self.vsites.spread(f, x)

    def _bin(self, xb: torch.Tensor, box: Optional[torch.Tensor] = None) -> NeighborState:
        order, cell_start, _, xw = bin_atoms(self.grid, xb, box)
        return NeighborState(order=order.contiguous(), cell_start=cell_start.contiguous(),
                             xw=xw)

    # --- what a box tensor changes ------------------------------------------------

    def _box(self, box) -> torch.Tensor:
        """``box`` as a (3,) float32 tensor on the system's device."""
        box = torch.as_tensor(box, dtype=torch.float32, device=self.system.device)
        if tuple(box.shape) != (3,):
            raise ValueError(f"box must be (3,), got {tuple(box.shape)}")
        return box

    def box_shifts(self, box: torch.Tensor) -> torch.Tensor:
        """The (27, 3) lattice shifts ``wx a + wy b + wz c`` of a (3,) box
        tensor, computed on the device (the table the kernel reads)."""
        if self._ratios is None:
            return (self._offsets * box).contiguous()
        from .box import latmul, traced_matrices

        H, _ = traced_matrices(box, self._ratios)
        return latmul(self._offsets, H).contiguous()

    def _poison(self, box: torch.Tensor) -> torch.Tensor:
        """NaN where a cell layer of ``box`` is thinner than the cutoff
        (the neighbourhoods would miss pairs), else 0; on the device."""
        if self._ratios is None:
            widths = box
        else:
            from .box import traced_perp_widths

            widths = traced_perp_widths(box, self._ratios)
        thin = (widths / self._ncell).min() < self.phys.rc
        return torch.where(thin, torch.full_like(box[0], math.nan), torch.zeros_like(box[0]))

    def _mesh_terms(self, xb: torch.Tensor, box: Optional[torch.Tensor]):
        """Reciprocal + self + background energies ``(R,)`` float64 and the
        reciprocal forces (autograd) of ``xb (R, N, 3)``."""
        if box is None:
            kw = dict(box=self.system.box, tilt=self.system.tilt)
            volume = float(np.prod(self.system.box))
        else:
            kw = dict(box=box, tilt_ratios=self._ratios)
            volume = (box[0] * box[1] * box[2]).double()
        with torch.enable_grad():
            y = xb.detach().requires_grad_(True)
            e = self.mesh.energy(y, self._q, precise=self.pme_precise, **kw)
            (g,) = torch.autograd.grad(e.sum(), y)
        return e.detach().double() + self.e_self + self._background_v / volume, -g

    # --- the sweep: plain twin and kernel ---------------------------------------------

    def half_shell(self, x: torch.Tensor, order: torch.Tensor, cell_start: torch.Tensor,
                   shifts: Optional[torch.Tensor] = None, home=None):
        """The pairs of one replica that the sweep takes, chunk by chunk:
        ``x (N, 3)`` the swept coordinates, ``order (N,)`` and ``cell_start
        (n_cells + 1,)`` its binning. Yields ``(ai, aj, d, pi, pj, cell, k)``
        for each chunk of cells and each offset ``k`` of ``HALF_SHELL``: the
        row atoms ``ai`` of ``cell`` and the column atoms ``aj`` of its
        neighbour through ``k``, their sorted positions ``pi``, ``pj``, and
        the float32 displacement ``d = x[ai] - (x[aj] + shift)`` as the
        kernel computes it, of every pair with ``|ai - aj| > D`` and
        ``1e-8 < r^2 < rc^2`` (on the own cell column after row). Each
        unordered image pair within the cutoff is yielded once. ``shifts``
        replaces the build box's lattice shifts (``box_shifts``); ``home``
        ``(lo, hi)`` restricts the row cells to that range (an x-slab's)."""
        n, dev = x.shape[0], x.device
        shifts = self._shifts if shifts is None else shifts
        cs, ordr = cell_start.long(), order.long()
        counts = cs[1:] - cs[:-1]
        M = int(counts.max())
        if M == 0:
            return
        slots = torch.arange(M, device=dev)
        valid = slots[None, :] < counts[:, None]                      # (C, M)
        pos = (cs[:-1, None] + slots[None, :]).clamp(max=n - 1)       # (C, M)
        atoms = ordr[pos]
        later = slots[None, :] > slots[:, None]                       # column after row
        lo, hi = (0, self.grid.n_cells) if home is None else home
        for c0 in range(lo, hi, self.cell_chunk):
            c1 = min(c0 + self.cell_chunk, hi)
            ai, vi, pi = atoms[c0:c1], valid[c0:c1], pos[c0:c1]
            xi = x[ai]                                                # (c, M, 3)
            for k in HALF_SHELL:
                nb = self._nb[k, c0:c1]
                aj, vj, pj = atoms[nb], valid[nb], pos[nb]
                xj = x[aj] + shifts[self._wrap[k, c0:c1]][:, None, :]
                d = xi[:, :, None, :] - xj[:, None, :, :]             # (c, M, M, 3)
                mask = (vi[:, :, None] & vj[:, None, :]
                        & ((ai[:, :, None] - aj[:, None, :]).abs() > self.band_D)
                        & cutoff_mask(d, self.phys.rc))
                if k == 13:
                    mask = mask & later
                c, r, col = mask.nonzero(as_tuple=True)
                yield (ai[c, r], aj[c, col], d[c, r, col], pi[c, r], pj[c, col], c + c0, k)

    def sweep_reference(self, xw: torch.Tensor, order: torch.Tensor,
                        cell_start: torch.Tensor, shifts: Optional[torch.Tensor] = None,
                        home=None):
        """``(e_rows (R, N) float64, forces (R, N, 3))`` by atom index (twin
        of ``cell_force_kernel``): every pair of ``half_shell`` from the home
        cells ``home`` (``None``: this rank's slab, all cells unsharded) once, half
        its energy to each atom's row, ``-W d`` to the row atom and ``+W d``
        to the column atom. The displacement and r^2 are float32 in the
        kernel's one orientation, so both cut the same pairs, and a pair on
        the cutoff is kept or cut for both of its atoms; the pair terms are
        evaluated in float64."""
        xw = self._batch(xw)
        R, n = xw.shape[0], xw.shape[1]
        dev = xw.device
        q, sig, seps = (row.double() for row in self._atom_p)
        e_rows = torch.zeros((R, n), dtype=torch.float64, device=dev)
        forces = torch.zeros((R, n, 3), dtype=torch.float64, device=dev)
        if home is None and self.slab is not None:
            home = (self.slab.lo, self.slab.hi)
        for rep in range(R):
            for ai, aj, d, *_ in self.half_shell(xw[rep], order[rep], cell_start[rep], shifts,
                                                 home):
                d = d.double()
                e_lj, e_el, w_lj, w_el, inv_r = pair_terms(
                    self.phys, (d * d).sum(-1), q[ai] * q[aj], 0.5 * (sig[ai] + sig[aj]),
                    seps[ai] * seps[aj])
                half = 0.5 * (e_lj + e_el)
                f = ((w_lj + w_el) * inv_r)[:, None] * d
                e_rows[rep].index_add_(0, ai, half).index_add_(0, aj, half)
                forces[rep].index_add_(0, ai, -f).index_add_(0, aj, f)
        return e_rows, forces.to(xw.dtype)

    def _launch(self, xw, order, cell_start, shifts=None):
        shifts = self._shifts if shifts is None else shifts
        for t, dtype in ((xw, torch.float32), (order, torch.int32),
                         (cell_start, torch.int32), (shifts, torch.float32)):
            if t.device.type != "cuda" or t.device != xw.device:
                raise RuntimeError(f"cell_force runs on CUDA tensors, got {t.device}")
            if t.dtype != dtype or not t.is_contiguous():
                raise TypeError(f"cell_force takes contiguous {dtype} tensors")
        R, n = xw.shape[0], xw.shape[1]
        if tuple(order.shape) != (R, n) or tuple(cell_start.shape) != (R, self.grid.n_cells + 1):
            raise ValueError("cell_force: order / cell_start do not match xw and the grid")
        shape, need = cell_scratch(R, n)
        refuse_scratch("cell_force", need, xw.device, R, n)
        lib = _library()
        e_rows = torch.empty((R, n), dtype=torch.float64, device=xw.device)
        forces = torch.empty_like(xw)
        scratch = torch.empty(shape, dtype=torch.float32, device=xw.device)
        phys, ewald = self.phys.kernel_args()
        rc = lib.pmarlo_cell_force(
            xw.data_ptr(), self._atom_p.data_ptr(), order.data_ptr(), cell_start.data_ptr(),
            R, n, self._dims, self.band_D, shifts.data_ptr(), phys, ewald,
            e_rows.data_ptr(), forces.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(xw.device).cuda_stream,
        )
        _kernels.check_launch(rc, "cell_force")
        launches["cell_force"] += 1
        return e_rows, forces

    def _launch_slab(self, xw, order, cell_start, shifts=None):
        """This rank's x-slab, one launch a replica: its rows of
        ``(e_rows, forces)``, the other rows zero."""
        shifts = self._shifts if shifts is None else shifts
        R, n = xw.shape[0], xw.shape[1]
        # pmarlo_cell_force_slab zeroes a replica's rows before it writes them
        e_rows = torch.empty((R, n), dtype=torch.float64, device=xw.device)
        forces = torch.empty_like(xw)
        lib = _library()
        phys, ewald = self.phys.kernel_args()
        sl = self.slab
        for rep in range(R):
            local, cs = sl.atoms(order[rep], cell_start[rep])
            m = int(local.shape[0])
            if m == 0:
                e_rows[rep].zero_()
                forces[rep].zero_()
                continue
            shape, need = cell_scratch(1, m)
            refuse_scratch("cell_force_slab", need, xw.device, 1, m)
            scratch = torch.empty(shape, dtype=torch.float32, device=xw.device)
            rc = lib.pmarlo_cell_force_slab(
                xw[rep].data_ptr(), self._atom_p.data_ptr(), local.data_ptr(), cs.data_ptr(),
                n, m, sl.dims, sl.hi - sl.lo, int(sl.wraps), self.band_D, shifts.data_ptr(),
                phys, ewald, e_rows[rep].data_ptr(), forces[rep].data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream(xw.device).cuda_stream,
            )
            _kernels.check_launch(rc, "cell_force_slab")
            launches["cell_force_slab"] += 1
        return e_rows, forces

    def scratch_bytes(self, x: torch.Tensor) -> int:
        """Bytes of the kernel scratch this rank allocates for ``x (N, 3)``
        (the largest of a batch's replicas): its slab's atoms with a mesh,
        all of them without."""
        xb = self._expand(self._batch(x.reshape((-1,) + tuple(x.shape[-2:]))))
        if self.slab is None:
            return cell_scratch(xb.shape[0], xb.shape[1])[1]
        st = self._bin(xb)
        return max(cell_scratch(1, int(self.slab.atoms(o, c)[0].shape[0]))[1]
                   for o, c in zip(st.order, st.cell_start))

    def sweep(self, xw, order, cell_start, shifts=None):
        """The band-masked sweep: the twin on the CPU, the kernel on CUDA
        (with a mesh this rank's slab of it)."""
        xw = self._batch(xw)
        if xw.device.type == "cpu":
            return self.sweep_reference(xw, order, cell_start, shifts)
        if self.slab is not None:
            return self._launch_slab(xw.contiguous(), order, cell_start, shifts)
        return self._launch(xw.contiguous(), order, cell_start, shifts)

    # --- assembly -------------------------------------------------------------------------

    def _evaluate(self, xb, st: NeighborState, sweep, box: Optional[torch.Tensor] = None):
        """``(energy, forces)`` of ``xb``, the site forces spread onto their
        parents. With a mesh the sweep is this rank's slab; what is not a
        pair sweep is added on the first rank alone, before the one sum over
        the ranks, so every rank gets the same bits (and nothing after the
        sum depends on the order of a rank's adds)."""
        shifts = None if box is None else self.box_shifts(box)
        e_rows, forces = sweep(st.xw, st.order, st.cell_start, shifts)
        energy = e_rows.sum(-1)
        if self.slab is None or self.slab.rank == 0:
            e_c, f_c = self.correction(xb, box)
            e_b, f_b = bonded_energy_and_forces(self._bonded, xb, energy_dtype=torch.float64)
            energy = energy + e_c + e_b
            if self._disp_2pi_c:
                energy = energy + (self.e_dispersion if box is None
                                   else self._disp_2pi_c / (box[0] * box[1] * box[2]).double())
            forces = forces + f_c + f_b
            if self.mesh is not None:
                e_m, f_m = self._mesh_terms(xb, box)
                energy, forces = energy + e_m, forces + f_m
        forces = self._spread(forces, xb)
        if self.slab is not None:
            from ..parallel.mesh import all_reduce_sum

            energy = all_reduce_sum(energy.contiguous(), self.slab.mesh)
            forces = all_reduce_sum(forces.contiguous(), self.slab.mesh)
        energy = energy.to(xb.dtype)
        if box is not None:
            poison = self._poison(box)
            energy, forces = energy + poison, forces + poison
        return energy, forces

    def evaluate(self, xs: torch.Tensor, st: NeighborState, box=None):
        """``(energies, forces)`` of ``xs (R, N, 3)`` swept on the binning
        ``st``, whose ``xw`` must be ``xs`` up to lattice vectors and cover
        every pair within the cutoff by its 27-cell neighbourhoods (binned
        under ``box``, the build box when None); virtual-site rows must be
        expanded in both (``init_state_batched`` bins so)."""
        xs = self._expand(self._batch(xs))
        return self._evaluate(xs, st, self.sweep, None if box is None else self._box(box))

    def _call(self, x, sweep, box=None):
        lead = tuple(x.shape[:-2])
        xb = self._expand(self._batch(x.reshape((-1,) + tuple(x.shape[-2:]))))
        energy, forces = self._evaluate(xb, self._bin(xb, box), sweep, box)
        return energy.reshape(lead), forces.reshape(tuple(x.shape))

    def __call__(self, x: torch.Tensor):
        """Energy and forces from a fresh binning: the kernel on a CUDA
        tensor, the twin on a CPU tensor."""
        return self._call(x, self.sweep)

    def reference(self, x: torch.Tensor, box=None):
        """The plain twin of the whole evaluation, on any device (under a
        box tensor ``box`` as ``dynamic`` evaluates)."""
        return self._call(x, self.sweep_reference, None if box is None else self._box(box))

    # --- stateful entries -------------------------------------------------------------------

    def init_state_batched(self, xs: torch.Tensor) -> NeighborState:
        return self._bin(self._expand(self._batch(xs)))

    def apply_batched(self, xs: torch.Tensor, st: NeighborState):
        """``(energies, forces, state)`` of ``xs (R, N, 3)``; ``state`` is
        the binning of ``xs`` (``st`` is not consulted: see the module
        docstring)."""
        xs = self._expand(self._batch(xs))
        st = self._bin(xs)
        energy, forces = self._evaluate(xs, st, self.sweep)
        return energy, forces, st

    def init_state(self, x: torch.Tensor) -> NeighborState:
        return self.init_state_batched(x[None])

    def apply(self, x: torch.Tensor, st: NeighborState):
        """``apply_batched`` for one configuration ``x (N, 3)``."""
        energy, forces, st = self.apply_batched(x[None], st)
        return energy[0], forces[0], st

    # --- NPT entries: the box an argument -------------------------------------------------

    def dynamic(self, x: torch.Tensor, box) -> tuple:
        """``(energy, forces)`` of ``x (..., N, 3)`` in the (3,) box ``box``
        (a tensor, or anything ``torch.as_tensor`` takes) with the grid's
        cell counts: NaN where a cell layer falls below the cutoff."""
        return self._call(x, self.sweep, self._box(box))

    def init_state_dynamic(self, x: torch.Tensor, box) -> NeighborState:
        """The binning of ``x (N, 3)`` under ``box``."""
        xb = self._expand(self._batch(x.reshape((-1,) + tuple(x.shape[-2:]))))
        return self._bin(xb, self._box(box))

    def apply_dynamic(self, x: torch.Tensor, st: NeighborState, box):
        """``(energy, forces, state)`` of ``x (N, 3)`` under ``box``; as
        ``apply``, it bins afresh (``st`` is not consulted) and returns the
        binning of ``x``."""
        box = self._box(box)
        xb = self._expand(self._batch(x.reshape((-1,) + tuple(x.shape[-2:]))))
        st = self._bin(xb, box)
        energy, forces = self._evaluate(xb, st, self.sweep, box)
        return energy.reshape(tuple(x.shape[:-2])), forces.reshape(tuple(x.shape)), st


def cell_scratch(R: int, n: int):
    """``(shape, bytes)`` of the kernel's float32 scratch for R replicas of n
    atoms: the atoms packed by sorted position (8 floats) and ``CELL_SLOTS``
    slots of a float4 (force, energy half-sum) an atom, 928 bytes; 25.8 MB
    at R = 1 on the 27,783-atom water box."""
    floats = R * n * (8 + 4 * CELL_SLOTS)
    return (floats,), 4 * floats


def build_cell_force_fn(
    system: System,
    *,
    occupancy_margin: float = 1.4,
    electrostatics: str = "rf",
    ewald_tolerance: float = 5e-4,
    mesh=None,
    dispersion_correction: bool = False,
    pme_mesh_refine: float = 1.0,
    pme_precise: bool = False,
    ewald_shift: bool = True,
    band: Optional[ExclusionBand] = None,
) -> CellForce:
    """The cell-list force function of ``system`` (tensors on
    ``system.device``), as ``pallas_cells.build_cell_force_fn`` builds it.

    ``electrostatics="rf"`` matches ``build_periodic_force_fn`` (the dense
    sweep): the same LJ shift or switch, reaction field and 1-4 semantics.
    ``electrostatics="pme"`` is smooth PME as JAX builds it: alpha from
    ``pme.ewald_alpha(cutoff, ewald_tolerance)``, order-6 splines on the
    mesh ``pme_grid_shape(lengths, pme_spacing(6, alpha) /
    pme_mesh_refine)``; ``pme_precise`` spreads with df32 fractional
    coordinates and weights (``pme.spread_charges_precise``);
    ``ewald_shift`` shifts the real-space term to zero at the cutoff (the
    exact-Ewald oracles turn it off). The grid has the most cells whose
    layers are at least one cutoff thick (no skin is bought: every call
    bins afresh); ``occupancy_margin`` sizes ``grid.capacity`` as JAX's grid
    does (the kernel reads no capacity). ``dispersion_correction`` adds the
    isotropic LJ tail energy 2 pi C / V (``md/dispersion.py``). The result
    carries ``grid``, ``electrostatics``, ``init_state`` / ``apply`` /
    ``init_state_batched`` / ``apply_batched``, ``evaluate``, the NPT
    entries ``dynamic`` / ``init_state_dynamic`` / ``apply_dynamic`` and,
    with PME, ``pme_order`` and ``pme_mesh_shape``.

    ``mesh`` (a 1-D ``DeviceMesh``, every rank calls this) splits the
    sweep into x-slabs over the ranks (module docstring): ``nx`` must
    divide over the mesh and leave room for the halo, as JAX requires; a
    1-rank mesh is the serial sweep. Every rank then returns the same
    energy and forces, and the result carries ``local_shapes``."""
    if system.box is None:
        raise ValueError("build_cell_force_fn needs system.box")
    if mesh is not None:
        from ..parallel.mesh import check_mesh

        check_mesh(mesh)
        if mesh.size() == 1:
            # the serial sweep: a 1-rank slab's halo would be its own layer 0
            mesh = None
    if electrostatics not in ("rf", "pme"):
        raise ValueError(f"electrostatics must be rf|pme, got {electrostatics!r}")
    n = system.n_atoms
    box_f = tuple(float(b) for b in system.box)
    tilt_f = system.tilt
    rc = float(system.cutoff)
    if tilt_f is not None:
        from .box import box_matrix, perp_widths, validate_reduced

        tilt_f = tuple(float(t) for t in tilt_f)
        H = box_matrix(box_f, tilt_f)
        validate_reduced(H)
        min_width = float(np.min(perp_widths(H)))
    else:
        min_width = min(box_f)

    grid = make_cell_grid(box_f, rc, n, occupancy_margin=occupancy_margin, tilt=tilt_f)
    if min_width < 2.0 * rc:
        # on a 1-/2-cell axis the neighbourhood holds the same cell through
        # both wrap directions with different shifts, so a pair appears at
        # distances d and L - d. Only one can pass r < rc when L >= 2 rc;
        # below that the pair would be counted twice, so refuse (the
        # minimum-image validity bound the dense sweep assumes too)
        raise ValueError(
            f"box {box_f} (tilt {tilt_f}) has a perpendicular width "
            f"smaller than 2*cutoff ({2 * rc}): periodic "
            "pairs would be double-counted (and the triclinic rounded "
            "minimum image would be unreliable). Use a larger box or a "
            "smaller cutoff."
        )
    if mesh is not None:
        n_dev = mesh.size()
        if grid.nx % n_dev != 0:
            raise ValueError(
                f"spatial decomposition needs n_cells_x ({grid.nx}) "
                f"divisible by the mesh size ({n_dev})"
            )
        cxl = grid.nx // n_dev
        if grid.nx < cxl + 2:
            raise ValueError(
                f"grid too small for sharded binning: the {cxl}-layer "
                f"slab's halo window ({cxl + 2} x-layers) exceeds the "
                f"{grid.nx}-layer grid (a cell would ghost onto itself); "
                "use more cells or fewer devices"
            )
    if electrostatics == "rf":
        phys = PairPhysics.from_system(system)
        return CellForce(system, grid, phys, band=band,
                         dispersion_correction=dispersion_correction, mesh=mesh)
    from .pme import ewald_alpha, mesh_lengths, pme_grid_shape, pme_spacing

    if pme_mesh_refine < 1.0:
        raise ValueError(f"pme_mesh_refine must be >= 1, got {pme_mesh_refine}")
    alpha = ewald_alpha(rc, ewald_tolerance)
    # order-6 splines on a ~1.3x coarser mesh than order 4's (JAX's choice)
    pme_order = 6
    shape = pme_grid_shape(mesh_lengths(box_f, tilt_f),
                           pme_spacing(pme_order, alpha) / pme_mesh_refine)
    phys = PairPhysics.from_system(system, ewald_alpha=alpha, ewald_shift=ewald_shift)
    return CellForce(system, grid, phys, band=band,
                     dispersion_correction=dispersion_correction,
                     pme_mesh=ReciprocalMesh(shape, pme_order, alpha, system.device),
                     pme_precise=pme_precise, mesh=mesh)


__all__ = ["CELL_SLOTS", "CELL_SPLITS", "CellForce", "HALF_SHELL", "Slab", "build_cell_force_fn",
           "cell_scratch", "launches"]
