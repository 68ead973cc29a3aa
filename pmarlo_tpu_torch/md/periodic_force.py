"""Explicit-solvent forces by a dense minimum-image sweep: one CUDA kernel
with its plain PyTorch twin.

Port of ``pmarlo_tpu/md/pallas_periodic.py build_periodic_force_fn``: the
periodic potential of a ``System`` with an orthorhombic box, LJ
(potential-shifted at the cutoff, or switched) + reaction-field Coulomb
with OpenMM CutoffPeriodic semantics (``forces.periodic_nonbonded_energy``
is the dense autograd reference), plus the bonded terms. A force
evaluation is

1. the sweep over all pairs with the index band ``|i - j| <= D`` masked:
   half-summed energy rows and forces (``csrc/periodic_force.cu`` on CUDA
   tensors, ``sweep_reference`` on CPU tensors: a CUDA tensor launches the
   kernel or raises). The kernel takes each unordered pair once, in blocks
   (row tile, column tile >= row tile) of ``PERIODIC_TILE`` atoms: its warps
   walk 32 x 32 patches, compact the pairs inside the cutoff onto full
   warps before the pair term, and write each block's sums to a slot
   scratch (``periodic_scratch``: R x ceil(N / 128) x N slots of 16 bytes,
   5.6 MB at R = 8, N = 2,315; refused past a quarter of the card's
   memory), which a second kernel adds in slot order, so two launches give
   the same bits. It is bound by instructions: every candidate pair's
   minimum image and r^2, and the pair term of the ~12% inside the cutoff;
2. the band add-back and the far-pair correction from the pair lists
   (``PairListCorrection``): every band pair at its wanted, scaled value,
   1-4 pairs as uncut bare Coulomb x ``scale_elec``, excluded pairs an
   exact zero. The TPU kernel streamed (N, N) scale tiles instead;
3. the bonded terms (``md/analytic.py``, index gathers).

``PairPhysics``, ``pair_terms`` and ``PairListCorrection`` are shared with
the cell-list path (``md/cell_force.py``), which runs the same physics
over the cells' half shell.

Pair arithmetic in the kernel is float32; energy rows are summed in float64
past a patch (the Coulomb terms of a water box cancel to ~1e-3 of their
magnitudes) and the plain twin evaluates in float64 outright, as the
reference the kernel is held to. Energies come back as float32.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import _kernels
from ..constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
from .analytic import bonded_energy_and_forces, make_bonded_params
from .cells import ExclusionBand
from .system import System
from .vsites import VirtualSites

_EPS = 1e-12
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)

#: kernel launches made by this process (chip_smoke.py resets and reads it)
launches = {"periodic_force": 0}

#: atoms a tile of the kernel's blocks (``csrc/periodic_force.cu`` kTile)
PERIODIC_TILE = 128

_configured = False


def _library() -> ctypes.CDLL:
    global _configured
    lib = _kernels.library()
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pmarlo_periodic_force.argtypes = [p, p, i, i, i, p, p, p, p, p, p]
        lib.pmarlo_periodic_force.restype = i
        _configured = True
    return lib


@dataclasses.dataclass(frozen=True)
class PairPhysics:
    """Constants of the periodic pair potential."""

    rc: float
    ke: float
    k_rf: float
    c_rf: float
    switch: Optional[float]      # LJ switch distance, None: potential shift
    ewald: bool = False          # real-space Ewald instead of reaction field
    alpha: float = 0.0
    shift_c: float = 0.0         # erfc(alpha rc) / rc

    @classmethod
    def from_system(cls, system: System, *, ewald_alpha: Optional[float] = None,
                    ewald_shift: bool = True) -> "PairPhysics":
        """``ewald_alpha``: real-space Ewald instead of reaction field;
        ``ewald_shift`` then shifts erfc(alpha r) / r to zero at the cutoff
        (off for the exact-Ewald oracles)."""
        rc = float(system.cutoff)
        eps_rf = float(system.solvent_dielectric)
        k_rf = (eps_rf - 1.0) / ((2.0 * eps_rf + 1.0) * rc**3)
        shift_c = 0.0
        if ewald_alpha is not None and ewald_shift:
            # the shift constant comes from the erfc the sweep itself uses
            # (on a card torch.erfc is the kernel's erfcf), so the shifted
            # energy is continuous at the cutoff to float32 rounding
            arg = torch.tensor(float(ewald_alpha) * rc, dtype=torch.float32,
                               device=system.device)
            shift_c = float(torch.erfc(arg)) / rc
        return cls(
            rc=rc, ke=COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 / float(system.solute_dielectric),
            k_rf=k_rf, c_rf=1.0 / rc + k_rf * rc * rc,
            switch=None if system.switch_distance is None else float(system.switch_distance),
            ewald=ewald_alpha is not None,
            alpha=0.0 if ewald_alpha is None else float(ewald_alpha), shift_c=shift_c,
        )

    def kernel_args(self):
        """(phys float[7], ewald flag) as the kernels' C interface takes them."""
        r_sw = -1.0 if self.switch is None else self.switch
        phys = (ctypes.c_float * 7)(self.rc, self.ke, self.k_rf, self.c_rf, self.alpha,
                                    self.shift_c, r_sw)
        return phys, int(self.ewald)


def pair_terms(phys: PairPhysics, r2: torch.Tensor, qq, sig, eps):
    """Full-strength pair terms at squared distance ``r2``, the expressions
    of ``csrc/periodic_pair.cuh``: ``(e_lj, e_el, w_lj, w_el, inv_r)`` with
    ``w = dE/dr``. ``sig`` and ``eps`` are the combined sigma and epsilon,
    ``qq`` the charge product; the cutoff is the caller's mask."""
    from .forces import lj_switch

    inv_r = torch.rsqrt(r2 + _EPS)
    r = r2 * inv_r
    sr6 = (sig * inv_r) ** 6
    lj = 4.0 * eps * (sr6 * sr6 - sr6)
    w_lj = 4.0 * eps * (-12.0 * sr6 * sr6 + 6.0 * sr6) * inv_r
    if phys.switch is None:
        sr6c = (sig * (1.0 / phys.rc)) ** 6
        e_lj = lj - 4.0 * eps * (sr6c * sr6c - sr6c)
    else:
        sw, dsw = lj_switch(r, phys.switch, phys.rc)
        e_lj = lj * sw
        w_lj = w_lj * sw + lj * dsw          # product rule: the S' term
    if phys.ewald:
        ar = phys.alpha * r
        erfc_ar = torch.erfc(ar)
        derfc = -_TWO_OVER_SQRT_PI * torch.exp(-ar * ar)
        e_el = phys.ke * qq * (erfc_ar * inv_r - phys.shift_c)
        w_el = phys.ke * qq * inv_r * (phys.alpha * derfc - erfc_ar * inv_r)
    else:
        e_el = phys.ke * qq * (inv_r + phys.k_rf * r * r - phys.c_rf)
        w_el = phys.ke * qq * (-inv_r * inv_r + 2.0 * phys.k_rf * r)
    return e_lj, e_el, w_lj, w_el, inv_r


def cutoff_mask(d: torch.Tensor, rc: float) -> torch.Tensor:
    """``1e-8 < r^2 < rc^2`` for float32 displacements ``d (..., 3)``, with
    r^2 = (dx dx + dy dy) + dz dz and rc^2 rounded as the kernels round them
    (``csrc/periodic_pair.cuh pair_r2``)."""
    d2 = d * d
    r2 = (d2[..., 0] + d2[..., 1]) + d2[..., 2]
    rc32 = torch.tensor(rc, dtype=torch.float32)
    return (r2 < float(rc32 * rc32)) & (r2 > 1e-8)


def make_min_image(system: System) -> Callable[..., torch.Tensor]:
    """``(d, box=None) -> minimum-image d`` for the system's box: per axis
    on an orthorhombic box, rounded fractional coordinates on a triclinic
    one (exact below half the smallest perpendicular width, which covers
    every pair within the cutoff). ``box``, a (3,) tensor, replaces the
    system's diagonal on the device (the NPT path); a triclinic cell keeps
    its tilt ratios (``md/box.py traced_matrices``)."""
    from .box import min_image_round, tilt_ratios, traced_matrices

    dev = system.device
    ratios = None if system.tilt is None else tilt_ratios(system.box, system.tilt)
    if system.tilt is None:
        box64 = torch.as_tensor(system.box, dtype=torch.float64, device=dev)
    else:
        from .box import box_matrix

        H = box_matrix(system.box, system.tilt)
        H64 = torch.as_tensor(H, dtype=torch.float64, device=dev)
        Hinv64 = torch.as_tensor(np.linalg.inv(H), dtype=torch.float64, device=dev)

    def min_image(d, box=None):
        if ratios is None:
            b = (box64 if box is None else box).to(d.dtype)
            return d - b * torch.round(d / b)
        if box is None:
            return min_image_round(d, H64.to(d.dtype), Hinv64.to(d.dtype))
        Hb, Hinvb = traced_matrices(box.to(d.dtype), ratios)
        return min_image_round(d, Hb, Hinvb)
    return min_image


class PairListCorrection:
    """Band add-back and far-pair correction over explicit pair lists.

    The sweeps mask every pair with ``|i - j| <= D``; here each band pair
    comes back at its wanted value (``pallas_cells.py _wanted_pair_energy``:
    shifted or switched LJ x ``scale_lj`` inside the cutoff; the sweep's
    Coulomb term inside the cutoff where ``scale_elec >= 1``, else uncut
    bare Coulomb x ``scale_elec``), so excluded pairs contribute an exact
    zero and nothing large is subtracted. Scaled pairs beyond the band were
    counted by the sweep at full strength: they are replaced (wanted minus
    counted) at their moderate distances. In Ewald mode every scaled pair
    also loses the erf part that a reciprocal sum counts. Energy and
    ``dE/dr`` are written out (index gathers and one ``index_add_``)."""

    def __init__(self, system: System, band: ExclusionBand, phys: PairPhysics):
        n, D = band.band_se.shape
        i = np.repeat(np.arange(n), D)
        k = np.tile(np.arange(1, D + 1), n)
        inside = i + k < n
        i, j = i[inside], (i + k)[inside]
        se = band.band_se.reshape(-1)[inside].astype(np.float64)
        sl = band.band_sl.reshape(-1)[inside].astype(np.float64)
        full = (se >= 1.0).astype(np.float64)
        fse = band.far_se.astype(np.float64)
        ffull = (fse >= 1.0).astype(np.float64)
        i = np.concatenate([i, band.far_idx[:, 0]])
        j = np.concatenate([j, band.far_idx[:, 1]])
        a_lj = np.concatenate([sl, band.far_sl.astype(np.float64) - 1.0])
        a_el = np.concatenate([full, ffull - 1.0])
        a_14 = np.concatenate([se * (1.0 - full), fse * (1.0 - ffull)])
        a_erf = -np.concatenate([1.0 - full, 1.0 - ffull]) * float(phys.ewald)
        keep = (a_lj != 0.0) | (a_el != 0.0) | (a_14 != 0.0) | (a_erf != 0.0)
        dev = system.device

        def host(t):
            return t.detach().cpu().double().numpy()

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64)[keep], device=dev)

        q, sig, eps = host(system.charges), host(system.lj_sigma), host(system.lj_eps)
        self.phys = phys
        self.i = torch.as_tensor(i[keep], dtype=torch.long, device=dev)
        self.j = torch.as_tensor(j[keep], dtype=torch.long, device=dev)
        self.a_lj, self.a_el, self.a_14, self.a_erf = f64(a_lj), f64(a_el), f64(a_14), f64(a_erf)
        self.qq = f64(q[i] * q[j])
        self.sig = f64(0.5 * (sig[i] + sig[j]))
        self.eps = f64(np.sqrt(np.maximum(eps[i] * eps[j], 0.0)))
        self.min_image = make_min_image(system)
        self._cast = {}

    def _params(self, dtype):
        if dtype not in self._cast:
            self._cast[dtype] = tuple(
                t.to(dtype) for t in (self.a_lj, self.a_el, self.a_14, self.a_erf,
                                      self.qq, self.sig, self.eps))
        return self._cast[dtype]

    def __call__(self, x: torch.Tensor, box: Optional[torch.Tensor] = None):
        """Energies ``(R,)`` float64 and forces ``(R, N, 3)`` of ``x (R, N,
        3)``; ``box``, a (3,) tensor, replaces the system's (NPT)."""
        forces = torch.zeros_like(x)
        if self.i.numel() == 0:
            return x.new_zeros(x.shape[0], dtype=torch.float64), forces
        p = self.phys
        a_lj, a_el, a_14, a_erf, qq, sig, eps = self._params(x.dtype)
        d = self.min_image(x[:, self.i] - x[:, self.j], box)
        r2 = (d * d).sum(-1)
        e_lj, e_el, w_lj, w_el, inv_r = pair_terms(p, r2, qq, sig, eps)
        within = (r2 < p.rc * p.rc).to(x.dtype)
        bare = a_14
        dbare = 0.0
        if p.ewald:
            ar = p.alpha * r2 * inv_r
            bare = a_14 + a_erf * torch.erf(ar)
            dbare = a_erf * (_TWO_OVER_SQRT_PI * p.alpha) * torch.exp(-ar * ar)
        coul = p.ke * qq * inv_r
        e = (a_lj * e_lj + a_el * e_el) * within + coul * bare
        dEdr = (a_lj * w_lj + a_el * w_el) * within + coul * (dbare - bare * inv_r)
        f_i = -(dEdr * inv_r)[..., None] * d
        forces.index_add_(1, self.i, f_i)
        forces.index_add_(1, self.j, -f_i)
        return e.sum(-1, dtype=torch.float64), forces


class PeriodicForce:
    """``fn(x) -> (energy, forces)`` for the full periodic potential of
    ``system``: ``x`` is ``(N, 3)`` or ``(R, N, 3)``; energies come back
    with the leading shape. Built by ``build_periodic_force_fn``.

    Virtual sites (``md/vsites.py``): ``__call__`` and ``reference``
    re-derive the site rows from their parents before the evaluation and
    spread the site forces onto the parents after it; the sweep sees the
    sites as atoms with charge and no LJ."""

    #: the evaluation handles the system's virtual sites itself
    expands_vsites = True

    def __init__(self, system: System, *, tile: int = 128,
                 band: Optional[ExclusionBand] = None):
        if system.box is None:
            raise ValueError("build_periodic_force_fn needs system.box")
        if system.tilt is not None:
            raise ValueError(
                "the dense periodic sweep is orthorhombic-only (per-axis "
                "minimum image on the box diagonal); triclinic cells need "
                "the cell-list engine (build_cell_force_fn)"
            )
        if int(tile) < 1:
            raise ValueError(f"tile must be positive, got {tile}")
        self.system = system
        self.tile = int(tile)
        self.phys = PairPhysics.from_system(system)
        self._atom_p = atom_rows(system)
        self.band = band if band is not None else ExclusionBand.from_system(system)
        if self.band.band_se.shape[0] != system.n_atoms:
            raise ValueError("exclusion band built for another system")
        self.band_D = int(self.band.width)
        self.correction = PairListCorrection(system, self.band, self.phys)
        self._bonded = make_bonded_params(system)
        self.vsites = VirtualSites.from_system(system)
        self._box = (ctypes.c_float * 3)(*system.box)
        self._box32 = torch.as_tensor(system.box, dtype=torch.float32, device=system.device)

    def _batch(self, x: torch.Tensor) -> torch.Tensor:
        n = self.system.n_atoms
        if x.dim() != 3 or tuple(x.shape[1:]) != (n, 3):
            raise ValueError(f"x must be (R, {n}, 3), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError("x must be float32")
        if x.device != self.system.device:
            raise ValueError(f"x on {x.device} but the periodic force was built "
                             f"for {self.system.device}")
        return x

    def sweep_reference(self, x: torch.Tensor):
        """``(e_rows (R, N) float64, forces (R, N, 3))`` of the band-masked
        sweep (twin of ``periodic_force_kernel``), row-chunked over ordered
        pairs. The minimum-image displacement and r^2 are float32, computed
        as the kernel computes them, so both cut the same pairs (the force
        jumps at the cutoff): the minimum image is an exact negation, so the
        kernel, which takes each unordered pair once in one orientation,
        decides each pair on the same r^2 as both of its ordered rows here.
        The pair terms are evaluated in float64."""
        x = self._batch(x)
        n = x.shape[1]
        q, sig, seps = (row.double() for row in self._atom_p)
        e_rows = torch.empty(x.shape[:2], dtype=torch.float64, device=x.device)
        forces = torch.empty_like(x)
        jj = torch.arange(n, device=x.device)[None, :]
        box = self._box32
        inv_box = 1.0 / box
        for s in range(0, n, self.tile):
            e = min(s + self.tile, n)
            d = x[:, s:e, None, :] - x[:, None, :, :]
            d = d - box * torch.round(d * inv_box)
            ii = torch.arange(s, e, device=x.device)[:, None]
            mask = ((ii - jj).abs() > self.band_D) & cutoff_mask(d, self.phys.rc)
            d = d.double()
            e_lj, e_el, w_lj, w_el, inv_r = pair_terms(
                self.phys, torch.where(mask, (d * d).sum(-1), 1.0),
                q[s:e, None] * q[None, :], 0.5 * (sig[s:e, None] + sig[None, :]),
                seps[s:e, None] * seps[None, :])
            m = mask.to(torch.float64)
            e_rows[:, s:e] = 0.5 * ((e_lj + e_el) * m).sum(-1)
            w = (w_lj + w_el) * inv_r * m
            forces[:, s:e] = (-(w[..., None] * d).sum(-2)).to(x.dtype)
        return e_rows, forces

    def _launch(self, x: torch.Tensor):
        if x.device.type != "cuda":
            raise RuntimeError(f"periodic_force runs on CUDA tensors, got {x.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError("periodic_force takes contiguous float32 tensors")
        R, n = x.shape[0], x.shape[1]
        shape, need = periodic_scratch(R, n)
        refuse_scratch("periodic_force", need, x.device, R, n)
        lib = _library()
        e_rows = torch.empty((R, n), dtype=torch.float64, device=x.device)
        forces = torch.empty_like(x)
        slots = torch.empty(shape, dtype=torch.float32, device=x.device)
        phys, _ = self.phys.kernel_args()
        rc = lib.pmarlo_periodic_force(
            x.data_ptr(), self._atom_p.data_ptr(), R, n, self.band_D, self._box, phys,
            e_rows.data_ptr(), forces.data_ptr(), slots.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _kernels.check_launch(rc, "periodic_force")
        launches["periodic_force"] += 1
        return e_rows, forces

    def sweep(self, x: torch.Tensor):
        """The band-masked sweep: the twin on the CPU, the kernel on CUDA."""
        x = self._batch(x)
        if x.device.type == "cpu":
            return self.sweep_reference(x)
        return self._launch(x.contiguous())

    def _evaluate(self, x, sweep):
        lead = tuple(x.shape[:-2])
        xb = self._batch(x.reshape((-1,) + tuple(x.shape[-2:])))
        if self.vsites is not None:
            xb = self.vsites.expand(xb)
        e_rows, forces = sweep(xb)
        e_c, f_c = self.correction(xb)
        e_b, f_b = bonded_energy_and_forces(self._bonded, xb, energy_dtype=torch.float64)
        energy = (e_rows.sum(-1) + e_c + e_b).to(xb.dtype)
        forces = forces + f_c + f_b
        if self.vsites is not None:
            forces = self.vsites.spread(forces, xb)
        return energy.reshape(lead), forces.reshape(tuple(x.shape))

    def __call__(self, x: torch.Tensor):
        """Energy and forces: the kernel on a CUDA tensor, the twin on a
        CPU tensor."""
        return self._evaluate(x, self.sweep)

    def reference(self, x: torch.Tensor):
        """The plain twin of the whole evaluation, on any device."""
        return self._evaluate(x, self.sweep_reference)


def periodic_scratch(R: int, n: int):
    """``(shape, bytes)`` of the dense kernel's float32 slot scratch for R
    replicas of n atoms: ceil(n / 128) slots an atom of a float4 (force,
    energy half-sum), 5.6 MB at R = 8, n = 2,315."""
    shape = (R, -(-n // PERIODIC_TILE), n, 4)
    return shape, 4 * math.prod(shape)


def refuse_scratch(name: str, need: int, device: torch.device, R: int, n: int) -> None:
    """Raise ``ValueError`` when a sweep's scratch of ``need`` bytes exceeds
    a quarter of the card's memory."""
    limit = torch.cuda.get_device_properties(device).total_memory // 4
    if need > limit:
        raise ValueError(
            f"{name}: the sweep's slot scratch for R={R}, N={n} takes "
            f"{need / 2**30:.1f} GiB, more than a quarter of the card's memory "
            f"({limit / 2**30:.1f} GiB); evaluate fewer replicas a call")


def atom_rows(system: System) -> torch.Tensor:
    """The sweeps' per-atom table ``(3, N)`` float32: charge, sigma and
    sqrt(epsilon) (the Lorentz-Berthelot mean is then a product)."""
    return torch.stack([
        system.charges.float(), system.lj_sigma.float(),
        torch.sqrt(torch.clamp(system.lj_eps.float(), min=0.0)),
    ]).contiguous()


def build_periodic_force_fn(system: System, *, tile: int = 128,
                            band: Optional[ExclusionBand] = None) -> PeriodicForce:
    """The dense periodic force function of ``system`` (tensors on
    ``system.device``), as ``pallas_periodic.build_periodic_force_fn``
    builds it. ``tile`` is the row chunk of the plain twin (its memory is
    O(tile * N)); the kernel's blocks are ``PERIODIC_TILE`` atoms, fixed in
    ``csrc/periodic_force.cu``. ``band`` overrides the exclusion band built
    from the system (``ExclusionBand.from_numpy`` carries JAX's). The
    system needs no (N, N) scale matrices."""
    return PeriodicForce(system, tile=tile, band=band)


__all__ = [
    "PERIODIC_TILE", "PairListCorrection", "PairPhysics", "PeriodicForce", "atom_rows",
    "build_periodic_force_fn", "cutoff_mask", "launches", "make_min_image", "pair_terms",
    "periodic_scratch", "refuse_scratch",
]
