"""Implicit-solvent forces without any (N, N) table: three GB pair sweeps
as CUDA kernels, each with its plain PyTorch twin.

Port of ``pmarlo_tpu/md/pallas_pair.py build_pair_force_fn``: the NoCutoff
LJ + Coulomb + GB (OBC2 or GBn2 with neck) + ACE surface term of the dense
path, and with ``gb_cutoff`` the large-assembly path on which every pair
term is cut at ``r > gb_cutoff`` and whole tile blocks out of range are
skipped. A force evaluation is

1. ``born``: the Born integral I_i (HCT + GBn2 neck), one pass over pairs;
2. glue: tanh rescale to Born radii B, with dB/dpsi (zero where 1/B is
   clamped at 1e-3, so the force stays the gradient of the energy);
3. ``energy_rows``: per-row LJ + Coulomb (index-band masked) + GB cross
   energy, and the pairwise part of dE/dB_i;
4. glue: self and SA terms, chain coefficients c = dE/dB dB/dpsi rho;
5. ``pair_forces``: F_i = -sum_j W_ij (x_i - x_j) / r;
6. the band add-back of the masked exclusions at their wanted scale
   (``md/cells.py``), and the bonded terms (index gathers, or the bonded
   kernel of ``md/bonded_window.py`` with ``bonded="window"``).

Sweeps 1, 3 and 5 are CUDA kernels on CUDA tensors and their twins
(``*_reference``, row-chunked so memory stays O(tile * N)) on CPU tensors:
a CUDA tensor launches the kernel or raises. Three sets of kernels compute
the same sums:

- dense (``gb_cutoff=None``): ``csrc/pair_force.cu``, each unordered pair
  once, in blocks of ``FORCE_TILE``-atom tiles whose per-slot sums go to a
  scratch the wrapper allocates and are added in a fixed order (the same
  bits from every launch);
- culled (``gb_cutoff``, ``newton=False``): kernels of the same file, every
  ordered pair, bit-reproducible: one walk for the three sweeps, a warp a
  32-atom row group and a segment of its column groups, over the 32 x 32
  atom patches of the tiles within reach whose group boxes are within the
  cutoff; the pairs inside the cutoff run on full warps, each pair's terms
  go to its row atom, and per-segment sums are added in a fixed order
  (``culled_scratch``);
- Newton (``newton=True``, the default with ``gb_cutoff``):
  ``csrc/pair_newton.cu``, each unordered pair once, results to both atoms
  (atomic adds: the last bits change from run to run), over a list of the
  32 x 32 atom patches within reach that the card builds from the live
  positions (``patch_list``): once an evaluation, for its three sweeps.

Steps 2, 4 and 6 are plain PyTorch on either device. ``launches`` counts
kernel launches by kernel name.

**Tiles.** With ``gb_cutoff`` the atoms are stored in tiles of ``tile``
atoms, in a Morton order of ``order_from`` when given (a layout only: the
band mask keys on the caller's atom indices and forces come back in the
caller's order). On every call ``tile_boxes`` takes each tile's bounding
box from the live positions and ``tiles_within`` marks the tile pairs whose
box gap is within the cutoff; kernels and twins read that one table, and a
skipped block holds no pair within the cutoff, so it contributes an exact
zero. There is no list of tiles of a fixed width, so the JAX path's list
overflow (``check_overflow``, its NaN poison) has no counterpart: any
geometry evaluates.

**The force jumps at the cutoff** (a hard truncation, for thermostatted
dynamics only, as in the JAX package). A kernel and its twin cut the same
pairs: both test the float32 ``r^2 = (dx dx + dy dy) + dz dz`` plus 1e-12
against one float32 threshold from the host (``cutoff_r2``), which decides
exactly as ``sqrt(r^2 + 1e-12) <= gb_cutoff`` would, without a square root
for a pair that is cut (``cutoff_pairs``, ``csrc/pair_r2.cuh``).

Pair arithmetic is float32, but the energy is summed in float64 (the
energy rows, the self/SA, correction and bonded sums) and the Born sums
too: near a minimum a protein's total energy is ~1% of its components, so
float32 totals would keep only three or four digits. The energy twin
evaluates its pair terms in float64 outright (see
``energy_rows_reference``). The energy comes back as float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
from .analytic import RowSums, bonded_energy_and_forces, make_bonded_params
from .bonded_window import build_bonded_window
from .cells import ExclusionBand
from .ff_params import OBC2_ALPHA, OBC2_BETA, OBC2_GAMMA
from .system import System, require_no_vsites

_EPS = 1e-12

_SWEEPS = ("born", "energy", "force")
_MODES = ("dense", "culled", "newton")


def kernel_name(sweep: str, mode: str) -> str:
    """The launch counter of one sweep in one mode: ``pair_born``,
    ``pair_born_culled``, ``pair_born_newton``, ..."""
    return f"pair_{sweep}" if mode == "dense" else f"pair_{sweep}_{mode}"


#: kernel launches made by this process, by kernel (chip_smoke.py resets
#: and reads them); one force evaluation on the card launches the three
#: sweeps of its mode once each
launches = {kernel_name(s, m): 0 for m in _MODES for s in _SWEEPS}

_configured = False


def _library() -> ctypes.CDLL:
    global _configured
    lib = _kernels.library()
    if not _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # x, atom_p, cls, orig, d0c, m0c, n_classes, B, chain, close, R, n,
        # tile, band, ke, gb_pref, cutoff_r2
        common = [p, p, p, p, p, p, i, p, p, p, i, i, i, i, f, f, f]
        # ..., use_gb, use_neck, out0, rows, slots, stream
        lib.pmarlo_pair_sweep.argtypes = [i, i] + common + [i, i, p, p, p, p]
        # sweep, x, atom_p, cls, orig, d0c, m0c, n_classes, B, chain, R, n,
        # band, ke, gb_pref, cutoff_r2, has_cut, use_gb, use_neck, out0,
        # rows, work, stream
        lib.pmarlo_pair_newton_sweep.argtypes = (
            [i, p, p, p, p, p, p, i, p, p, i, i, i, f, f, f, i, i, i, p, p, p, p])
        # x, close, R, n, tile, cutoff_r2, has_cut, work, stream
        lib.pmarlo_pair_newton_list.argtypes = [p, p, i, i, i, f, i, p, p]
        sizes = (lib.pmarlo_pair_max_classes, lib.pmarlo_pair_force_tile,
                 lib.pmarlo_pair_culled_segments)
        for fn in (lib.pmarlo_pair_sweep, lib.pmarlo_pair_newton_sweep,
                   lib.pmarlo_pair_newton_list, *sizes):
            fn.restype = i
        for fn in sizes:
            fn.argtypes = []
        lib.pmarlo_pair_newton_work_size.argtypes = [i, i]
        lib.pmarlo_pair_culled_scratch.argtypes = [i, i, i]
        for fn in (lib.pmarlo_pair_newton_work_size, lib.pmarlo_pair_culled_scratch):
            fn.restype = ctypes.c_longlong
        if lib.pmarlo_pair_max_classes() != MAX_CLASSES:
            raise RuntimeError("kernel library and wrapper disagree on MAX_CLASSES")
        if lib.pmarlo_pair_force_tile() != FORCE_TILE:
            raise RuntimeError("kernel library and wrapper disagree on FORCE_TILE")
        if lib.pmarlo_pair_culled_segments() != CULLED_SEGMENTS:
            raise RuntimeError("kernel library and wrapper disagree on CULLED_SEGMENTS")
        if any(lib.pmarlo_pair_culled_scratch(code, R, n) != culled_scratch(sweep, R, n)
               for code, sweep in enumerate(_SWEEPS) for R, n in ((1, 61_824), (3, 33))):
            raise RuntimeError("kernel library and wrapper disagree on the culled scratch")
        _configured = True
    return lib


#: radius classes the kernels hold in shared memory (csrc/pair_force.cu)
MAX_CLASSES = 64
#: atoms a row group of the culled and Newton kernels' walks: their tiles
#: are multiples of it
ROW_BLOCK = 32
#: atoms a tile of the dense kernels, which take each (row tile, column
#: tile >= row tile) block once (csrc/pair_force.cu)
FORCE_TILE = 128
#: per-atom components and type of each dense sweep's slots: its scratch is
#: (R, ceil(N / FORCE_TILE), N, *components) (csrc/pair_force.cu)
_DENSE_SLOTS = {"born": ((), torch.float64), "energy": ((2,), torch.float64),
               "force": ((3,), torch.float32)}


#: work items a 32-atom row group of the culled kernels: its column groups
#: h split by h mod CULLED_SEGMENTS, each item's sums to its own slot
CULLED_SEGMENTS = 4
#: bytes of one atom's slot in each culled sweep's scratch: Born I and the
#: energy row and dE/dB in float64, force F in float32 (csrc/pair_force.cu)
_CULLED_SLOT_BYTES = {"born": 8, "energy": 16, "force": 12}


def culled_scratch(sweep: str, R: int, n: int) -> int:
    """Bytes of one culled kernel's scratch for R replicas of n atoms: the
    32-atom groups' boxes ``(R, ceil(n / 32), 6)`` float32, then the
    per-segment slots ``(R, CULLED_SEGMENTS, n, K)`` (Born 2.0 MB, energy
    4.0 MB, force 3.0 MB at R = 1, n = 61,824)."""
    return R * (-(-n // 32) * 6 * 4 + CULLED_SEGMENTS * n * _CULLED_SLOT_BYTES[sweep])


def culled_force_scratch(R: int, n: int) -> int:
    """float32 entries of the culled force kernel's scratch for R replicas
    of n atoms: the 32-atom groups' boxes ``(R, ceil(n / 32), 6)``, then the
    per-segment slots ``(R, CULLED_SEGMENTS, n, 3)`` (3 MB at R = 1, n =
    61,824)."""
    return culled_scratch("force", R, n) // 4


def dense_scratch(sweep: str, R: int, n: int) -> Tuple[tuple, torch.dtype, int]:
    """``(shape, dtype, bytes)`` of the slot scratch of one dense sweep of R
    replicas of n atoms: ~R n^2 / 8 bytes for the energy sweep (the
    largest), 14.3 MB at R = 8, n = 3,726."""
    components, dtype = _DENSE_SLOTS[sweep]
    shape = (R, -(-n // FORCE_TILE), n) + components
    return shape, dtype, math.prod(shape) * torch.finfo(dtype).bits // 8


def _electrostatic_constants(system: System, dtype: torch.dtype) -> Tuple[float, float]:
    """``(ke, gb_pref)``: Coulomb's constant over the solute dielectric and
    the GB prefactor. The kernels take both as float (their C interface),
    and JAX's float32 kernels round them so too (a Python float in float32
    arithmetic), so the float32 path, plain versions included, takes the
    float32 values; a float64 twin keeps them exact, so that it measures
    the float32 path's rounding of them too."""
    ke = COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 / system.solute_dielectric
    gb_pref = (-0.5 * COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
               * (1.0 / system.solute_dielectric - 1.0 / system.solvent_dielectric))
    if dtype == torch.float32:
        return float(np.float32(ke)), float(np.float32(gb_pref))
    return ke, gb_pref


def _morton_order(x: np.ndarray, bits: int = 10) -> np.ndarray:
    """Spatial (Morton/Z-order) permutation: index-contiguous tiles
    become spatially COMPACT blobs, which is what makes bounding-box
    tile culling effective when the chain folds back through space.
    Host-side, build time only (the permutation is static; culling
    CORRECTNESS never depends on it — tile AABBs are recomputed
    from live positions every force evaluation)."""
    x = np.asarray(x, np.float64)
    lo = x.min(axis=0)
    span = max(float((x.max(axis=0) - lo).max()), 1e-9)
    g = np.clip(((x - lo) / span * (2**bits - 1)).astype(np.uint64),
                0, np.uint64(2**bits - 1))

    def part1by2(v):
        v = v & np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x30000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x9249249)
        return v

    code = (part1by2(g[:, 0]) | (part1by2(g[:, 1]) << np.uint64(1))
            | (part1by2(g[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable").astype(np.int32)


def _r2(d: torch.Tensor) -> torch.Tensor:
    """``(dx dx + dy dy) + dz dz`` of displacements ``d (..., 3)``, each
    product and sum rounded on its own, as ``csrc/pair_r2.cuh`` does."""
    d2 = d * d
    return (d2[..., 0] + d2[..., 1]) + d2[..., 2]


def cutoff_r2(cutoff: float) -> float:
    """The largest float32 ``t`` with ``sqrt(t) <= cutoff`` in float32. The
    float32 square root is monotonic and correctly rounded, so ``s <= t``
    decides as ``sqrt(s) <= cutoff`` does for every float32 ``s``: the
    kernels and their twins reject a pair without taking its root."""
    c = np.float32(cutoff)
    zero, inf = np.float32(0.0), np.float32(np.inf)
    t = np.float32(np.float64(c) * np.float64(c))
    while np.sqrt(t) > c:
        t = np.nextafter(t, zero)
    while np.sqrt(np.nextafter(t, inf)) <= c:
        t = np.nextafter(t, inf)
    return float(t)


def cutoff_pairs(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Pairs within the GB cutoff: ``r^2 + 1e-12 <= cutoff_r2(cutoff)`` on
    the float32 r^2 of the float32 displacements ``d (..., 3)``, the number
    the kernels test (``csrc/pair_force.cu``, ``csrc/pair_newton.cu``); the same
    pairs as ``sqrt(r^2 + 1e-12) <= cutoff``."""
    d = d.float()
    return _r2(d) + _EPS <= cutoff_r2(cutoff)


def tile_boxes(xs: torch.Tensor, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounding boxes ``(lo, hi)``, each ``(R, G, 3)`` float32, of the G
    tiles of ``tile`` consecutive atoms of ``xs (R, N, 3)``; the ragged last
    tile holds the atoms it has."""
    xs = xs.float()
    R, n = xs.shape[0], xs.shape[1]
    pad = -n % tile
    if pad:
        # the last atom again: it lies inside its own tile's box
        xs = torch.cat([xs, xs[:, -1:].expand(R, pad, 3)], 1)
    xr = xs.reshape(R, -1, tile, 3)
    return xr.amin(2), xr.amax(2)


def tiles_within(lo: torch.Tensor, hi: torch.Tensor, cutoff: float) -> torch.Tensor:
    """``(R, G, G)`` bool: tile pairs whose boxes are at most ``cutoff``
    apart. The gap is tested as a pair's distance is (``cutoff_pairs``):
    per axis it is the difference of two atoms' coordinates and no larger
    than that of any pair of the two tiles, and every later operation is
    monotonic, so an excluded tile pair holds no pair within the cutoff."""
    gap = torch.maximum(lo[:, :, None] - hi[:, None, :], lo[:, None, :] - hi[:, :, None])
    return cutoff_pairs(gap.clamp_min(0.0), cutoff)


def _radius_classes(rho: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(class values (C,), class index (N,)) of the distinct offset radii,
    as ``pallas_pair._radius_classes`` groups them."""
    vals, inv = np.unique(np.round(rho, 9), return_inverse=True)
    return vals, inv.astype(np.int32)


def _hct(r, inv_r, rho_a, sr_b, value: bool = True, derivative: bool = True):
    """HCT integrand H(r; rho_a, sr_b) and dH/dr, zero for inactive pairs
    (the expressions of ``pallas_pair.hct_terms``); a part not asked for
    comes back as ``None``."""
    U_raw = r + sr_b
    inactive = U_raw <= rho_a
    U = torch.where(inactive, rho_a + 1.0, U_raw)
    absd = torch.abs(r - sr_b)
    use_rho = absd < rho_a
    L = torch.where(use_rho, rho_a, absd)
    inv_L = 1.0 / L
    inv_U = 1.0 / U
    log_LU = torch.log(L * inv_U)
    quad = r - sr_b * sr_b * inv_r
    engulfed = (sr_b - r) > rho_a
    act = (~inactive).to(r.dtype)
    H = dH = None
    if value:
        H = (inv_L - inv_U
             + 0.25 * quad * (inv_U * inv_U - inv_L * inv_L)
             + 0.5 * log_LU * inv_r)
        H = H + torch.where(engulfed, 2.0 * (1.0 / rho_a - inv_L), 0.0)
        H = H * act
    if derivative:
        sgn = torch.sign(r - sr_b)
        dL = torch.where(use_rho, 0.0, sgn)
        dquad = 1.0 + sr_b * sr_b * inv_r * inv_r
        dH = (-dL * inv_L * inv_L
              + inv_U * inv_U
              + 0.25 * dquad * (inv_U * inv_U - inv_L * inv_L)
              + 0.25 * quad * (-2.0 * inv_U**3 + 2.0 * dL * inv_L**3)
              - 0.5 * log_LU * inv_r * inv_r
              + 0.5 * inv_r * (dL * inv_L - inv_U))
        dH = dH + torch.where(engulfed, 2.0 * dL * inv_L * inv_L, 0.0)
        dH = dH * act
    return H, dH


def _neck(r, d0, m0s):
    """GBn2 neck value (scale folded into ``m0s``) and its r-derivative."""
    u = r - d0
    u2 = u * u
    denom = 1.0 + 100.0 * u2 + 0.3e6 * u2 * u2 * u2
    nv = m0s / denom
    dnv = -(nv / denom) * (200.0 * u + 1.8e6 * u2 * u2 * u)
    return nv, dnv


def _sr6(sig, inv_r):
    s = sig * inv_r
    s2 = s * s
    return s2 * s2 * s2


class PairForce:
    """``fn(x) -> (energy, forces)`` for the full potential of ``system``:
    ``x`` is ``(N, 3)`` or ``(R, N, 3)``; energies come back with the
    leading shape (``()`` or ``(R,)``). Built by ``build_pair_force_fn``.

    The per-sweep entry points (``born``, ``energy_rows``, ``pair_forces``
    and their ``*_reference`` twins) take and return arrays in **storage
    order** (``to_storage`` / ``from_storage``; the caller's order unless a
    Morton order was asked for), ``(R, N, ...)`` only."""

    def __init__(self, system: System, *, tile: int = 128,
                 band: Optional[ExclusionBand] = None,
                 dtype: torch.dtype = torch.float32,
                 gb_cutoff: Optional[float] = None,
                 perm: Optional[np.ndarray] = None,
                 newton: bool = False, bonded: str = "gather"):
        require_no_vsites(system, "the pair force path")
        if system.box is not None:
            raise ValueError(
                "the pair force path is an implicit-solvent path and takes no box "
                "(a boxed system is explicit solvent: build_periodic_force_fn or "
                "build_cell_force_fn)"
            )
        if int(tile) < 1:
            raise ValueError(f"tile must be positive, got {tile}")
        if gb_cutoff is not None and not float(gb_cutoff) > 0.0:
            raise ValueError(f"gb_cutoff must be positive, got {gb_cutoff}")
        self.system = system
        self.tile = int(tile)
        self.dtype = dtype
        self.gb_cutoff = None if gb_cutoff is None else float(gb_cutoff)
        self._cut_r2 = 0.0 if gb_cutoff is None else cutoff_r2(self.gb_cutoff)
        self.newton = bool(newton)
        self.mode = "newton" if self.newton else ("dense" if gb_cutoff is None else "culled")
        n = system.n_atoms
        dev = system.device
        if perm is not None:
            perm = np.asarray(perm, np.int64)
            if self.gb_cutoff is None:
                raise ValueError("a storage order only affects the gb_cutoff path")
            if not np.array_equal(np.sort(perm), np.arange(n)):
                raise ValueError("perm must be a permutation of the atoms")
        #: storage slot k holds the caller's atom ``perm[k]`` (None: identity)
        self.perm = (None if perm is None
                     else torch.as_tensor(perm, dtype=torch.long, device=dev))

        def host(t):
            return t.detach().cpu().double().numpy()

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        def stored(a):
            """A per-atom host array as a tensor in storage order."""
            return f32(a if perm is None else np.asarray(a)[perm])

        q = host(system.charges)
        radii = host(system.gb_radii)
        rho = radii - system.gb_offset
        sr = host(system.gb_screen) * rho
        self.use_gb = bool(system.use_gb)
        self.ke, self.gb_pref = _electrostatic_constants(system, dtype)
        probe = 0.14
        if system.gb_alpha is not None:
            ab, bb, gb = (host(system.gb_alpha), host(system.gb_beta),
                          host(system.gb_gamma))
        else:
            ab = np.full(n, OBC2_ALPHA)
            bb = np.full(n, OBC2_BETA)
            gb = np.full(n, OBC2_GAMMA)
        self.q, self.rho, self.radii = stored(q), stored(rho), stored(radii)
        self.sr = stored(sr)
        self.sig = stored(host(system.lj_sigma))
        # sqrt(eps) per atom: the Lorentz-Berthelot mean is a product
        self.seps = stored(np.sqrt(np.maximum(host(system.lj_eps), 0.0)))
        self.sa = stored(system.surface_tension * (radii + probe) ** 2 * radii**6)
        self.ab, self.bb, self.gb = stored(ab), stored(bb), stored(gb)
        # the kernels' float32 copies of the per-atom rows and class tables
        self._atom_p = torch.stack(
            [self.q, self.sig, self.seps, self.rho, self.sr]
        ).float().contiguous()
        # the caller's index of each stored atom: the band mask keys on it
        self._orig = torch.as_tensor(np.arange(n) if perm is None else perm,
                                     dtype=torch.int32, device=dev)
        self._orig_long = self._orig.long()

        self.use_neck = (self.use_gb and system.gb_neck_scale != 0.0
                         and system.gb_model == "gbn2")
        if self.use_neck:
            from .gbn2 import lookup_neck

            vals, cls = _radius_classes(rho)
            C = len(vals)
            d0c, m0c = lookup_neck(np.repeat(vals[:, None], C, 1),
                                   np.repeat(vals[None, :], C, 0))
            m0c = m0c * float(system.gb_neck_scale)
            if C > MAX_CLASSES:
                raise ValueError(
                    f"{C} GB radius classes; the kernels hold {MAX_CLASSES}"
                )
            # the force pass uses one neck derivative for both directions
            if not (np.allclose(d0c, d0c.T, rtol=0, atol=1e-12)
                    and np.allclose(m0c, m0c.T, rtol=0, atol=1e-12)):
                raise ValueError("GBn2 neck class tables are not symmetric")
        else:
            cls = np.zeros(n, np.int32)
            d0c = m0c = np.zeros((1, 1))
        if perm is not None:
            cls = cls[perm]
        self._cls = torch.as_tensor(cls, dtype=torch.int32, device=dev)
        self._cls_long = self._cls.long()
        self._d0c = f32(d0c)
        self._m0c = f32(m0c)
        self._d0c_k = self._d0c.float().contiguous()
        self._m0c_k = self._m0c.float().contiguous()

        # the band add-back works on the caller's order
        self.band = band if band is not None else ExclusionBand.from_system(system)
        if self.band.band_se.shape[0] != n:
            raise ValueError("exclusion band built for another system")
        self.band_D = int(self.band.width)
        pi, pj, c_el, c_lj = self.band.correction_pairs()
        eps_all = host(system.lj_eps)
        sig_all = host(system.lj_sigma)
        self._corr_i = torch.as_tensor(pi, dtype=torch.long, device=dev)
        self._corr_j = torch.as_tensor(pj, dtype=torch.long, device=dev)
        # each atom's band pairs added in one fixed order
        self._corr_rows = RowSums(np.concatenate([pi, pj]), n, dev)
        self._corr_sig = f32(0.5 * (sig_all[pi] + sig_all[pj]))
        self._corr_lj = f32(4.0 * c_lj * np.sqrt(np.maximum(
            eps_all[pi] * eps_all[pj], 0.0)))
        self._corr_el = f32(self.ke * c_el * q[pi] * q[pj])
        if bonded not in ("gather", "window"):
            raise ValueError(f"bonded must be gather|window, got {bonded!r}")
        self.bonded = bonded
        self._bonded = make_bonded_params(system, dtype=dtype)
        #: the bonded kernel (``bonded="window"``); None without bonded terms
        self._bonded_kernel = build_bonded_window(system) if bonded == "window" else None

    # --- shapes -----------------------------------------------------------------

    def _batch(self, x: torch.Tensor) -> torch.Tensor:
        n = self.system.n_atoms
        if x.dim() != 3 or tuple(x.shape[1:]) != (n, 3):
            raise ValueError(f"x must be (R, {n}, 3), got {tuple(x.shape)}")
        if x.dtype != self.dtype:
            raise TypeError(f"x must be {self.dtype}")
        if x.device != self.system.device:
            raise ValueError(
                f"x on {x.device} but the pair force was built for "
                f"{self.system.device}"
            )
        return x

    def to_storage(self, a: torch.Tensor) -> torch.Tensor:
        """A per-atom array ``(R, N, ...)`` from the caller's order into
        storage order."""
        return a if self.perm is None else a[:, self.perm]

    def from_storage(self, a: torch.Tensor) -> torch.Tensor:
        """The inverse of ``to_storage``."""
        if self.perm is None:
            return a
        out = torch.empty_like(a)
        out[:, self.perm] = a
        return out

    @property
    def n_tiles(self) -> int:
        return -(-self.system.n_atoms // self.tile)

    def close_tiles(self, xs: torch.Tensor) -> Optional[torch.Tensor]:
        """``(R, G, G)`` bool table of the tile blocks to compute at the
        stored positions ``xs``; ``None`` without a cutoff (every block)."""
        if self.gb_cutoff is None:
            return None
        return tiles_within(*tile_boxes(xs, self.tile), self.gb_cutoff)

    # --- plain PyTorch twins of the kernels -------------------------------------

    def _blocks(self, x, close):
        """Row tiles ``(s, e, cols, d, r, one)``: the columns ``cols`` the
        row tile s:e meets (``None``: all atoms; an index tensor on the
        culled and Newton paths), separations ``(R, c, m, 3)``, distances
        with self and coincident slots pushed to 1 nm, and the mask of the
        pairs to count: genuine, within the cutoff, and on the Newton path
        each unordered pair once (column after row in storage order)."""
        n = x.shape[1]
        if self.gb_cutoff is not None and close is None:
            close = self.close_tiles(x)
        tiles = torch.arange(self.n_tiles, device=x.device)
        within_tile = torch.arange(self.tile, device=x.device)
        for s in range(0, n, self.tile):
            e = min(s + self.tile, n)
            t = s // self.tile
            cols = None
            if close is not None or self.newton:
                # a tile any replica needs is computed for all: the pair
                # mask zeroes what a replica's own table would have skipped
                keep = (close[:, t].any(0) if close is not None
                        else torch.ones_like(tiles, dtype=torch.bool))
                if self.newton:
                    keep = keep & (tiles >= t)
                cols = (tiles[keep][:, None] * self.tile + within_tile).reshape(-1)
                cols = cols[cols < n]
                if cols.numel() == 0:
                    continue
            xc = x if cols is None else x[:, cols]
            d = x[:, s:e, None, :] - xc[:, None, :, :]
            r2 = _r2(d)
            pair = r2 > 1e-8
            r = torch.where(pair, torch.sqrt(r2 + _EPS), torch.ones_like(r2))
            if self.gb_cutoff is not None:
                # decided on float32 numbers whatever type the terms take
                d32 = d if d.dtype == torch.float32 else (
                    x[:, s:e, None, :].float() - xc[:, None, :, :].float())
                pair = pair & cutoff_pairs(d32, self.gb_cutoff)
            if self.newton:
                rows_at = torch.arange(s, e, device=x.device)[:, None]
                pair = pair & (cols[None, :] > rows_at)
            yield s, e, cols, d, r, pair.to(x.dtype)

    @staticmethod
    def _at(a: torch.Tensor, cols) -> torch.Tensor:
        """The column entries of a per-atom array ``(..., N)``."""
        return a if cols is None else a[..., cols]

    def _neck_tables(self, s, e, cols):
        ci = self._cls_long[s:e, None]
        cj = self._at(self._cls_long, cols)[None, :]
        return self._d0c[ci, cj], self._m0c[ci, cj]

    def born_pair_terms(self, s, e, cols, r, one, columns: bool = False):
        """What each pair of the row atoms s:e and the column atoms ``cols``
        (``None``: all) adds to the Born integrals, ``(R, e - s, m)``: to the
        row atom's ``H(r; rho_i, sr_j) / 2 + neck``, and with ``columns`` to
        the column atom's ``H(r; rho_j, sr_i) / 2 + neck`` (else ``None``);
        ``r`` the distances, ``one`` the mask of the pairs to count."""
        inv_r = 1.0 / r
        H, _ = _hct(r, inv_r, self.rho[s:e, None], self._at(self.sr, cols)[None, :],
                    derivative=False)
        to_row = 0.5 * H * one
        to_col = None
        if columns:
            Hc, _ = _hct(r, inv_r, self._at(self.rho, cols)[None, :], self.sr[s:e, None],
                         derivative=False)
            to_col = 0.5 * Hc * one
        if self.use_neck:
            d0, m0 = self._neck_tables(s, e, cols)
            nv, _ = _neck(r, d0, m0)
            # the class tables are symmetric: one neck value serves both atoms
            neck = nv * one
            to_row = to_row + neck
            if columns:
                to_col = to_col + neck
        return to_row, to_col

    def born_reference(self, x: torch.Tensor, close=None) -> torch.Tensor:
        """Born integral ``I (R, N)`` (twin of the Born kernels)."""
        x = self._batch(x)
        f64 = torch.float64
        out = torch.zeros(x.shape[:2], dtype=f64, device=x.device)
        for s, e, cols, _, r, one in self._blocks(x, close):
            to_row, to_col = self.born_pair_terms(s, e, cols, r, one, columns=self.newton)
            out[:, s:e] += to_row.sum(-1, dtype=f64)
            if self.newton:
                out.index_add_(1, cols, to_col.sum(-2, dtype=f64))   # the column atoms' share
        return out.to(x.dtype)

    def _band_mask(self, s, e, cols):
        ii = self._orig_long[s:e, None]
        jj = self._at(self._orig_long, cols)[None, :]
        return (ii - jj).abs() > self.band_D

    def energy_pair_terms(self, B, s, e, cols, r, one, columns: bool = False):
        """Each pair's energy terms ``(R, e - s, m)`` in the type of ``r``:
        ``(e_pair, dEdB_row, dEdB_col)``, with e_pair = 0.5 e_nb + e_gb the
        energy the unordered pair adds to each of its two atoms' rows (LJ +
        Coulomb outside the index band, the GB cross term), dEdB_row the
        row atom's d(e_gb)/dB and, with ``columns``, dEdB_col the column
        atom's (else ``None``; both ``None`` without GB)."""
        dt = r.dtype
        q, sig, seps = self.q.to(dt), self.sig.to(dt), self.seps.to(dt)
        inv_r = 1.0 / r
        ob = self._band_mask(s, e, cols).to(dt)
        sr6 = _sr6(0.5 * (sig[s:e, None] + self._at(sig, cols)[None, :]), inv_r)
        eps = seps[s:e, None] * self._at(seps, cols)[None, :]
        qq = q[s:e, None] * self._at(q, cols)[None, :]
        e_nb = (4.0 * eps * (sr6 * sr6 - sr6) + self.ke * qq * inv_r) * ob
        e_pair = 0.5 * e_nb * one
        db_row = db_col = None
        if self.use_gb:
            B = B.to(dt)
            Bi = B[:, s:e, None]
            Bj = self._at(B, cols)[:, None, :]
            BB = Bi * Bj
            rsq = r * r
            expu = torch.exp(-rsq / (4.0 * BB))
            inv_f = 1.0 / torch.sqrt(rsq + BB * expu)
            qq_gb = self.gb_pref * qq
            e_pair = e_pair + qq_gb * inv_f * one
            dEdf = -qq_gb * inv_f * inv_f * one
            db_row = dEdf * (expu * (Bj + rsq / (4.0 * Bi)) * (0.5 * inv_f))
            if columns:
                db_col = dEdf * (expu * (Bi + rsq / (4.0 * Bj)) * (0.5 * inv_f))
        return e_pair, db_row, db_col

    def energy_rows_reference(self, x: torch.Tensor, B: torch.Tensor, close=None):
        """``(e_rows (R, N) float64, dEdB_pair (R, N))`` (twin of the energy
        kernels). On the Newton path a pair's energy goes to its row atom
        (the earlier one in storage order), so the rows sum to the same
        total. The pair terms are evaluated in float64:
        as the reference the kernel's energies are held to, the twin must
        not carry float32's correlated rounding (a few dozen distinct
        charge products repeat over millions of pairs, so their rounding
        errors add up instead of averaging out)."""
        x = self._batch(x)
        f64 = torch.float64
        e_out = torch.zeros(x.shape[:2], dtype=f64, device=x.device)
        b_out = torch.zeros(x.shape[:2], dtype=f64, device=x.device)
        # each unordered pair once, all of it to the row atom (Newton), or
        # both ordered directions, each atom's row half of each
        share = 2.0 if self.newton else 1.0
        for s, e, cols, _, r, one in self._blocks(x.to(f64), close):
            e_pair, db_row, db_col = self.energy_pair_terms(B, s, e, cols, r, one,
                                                            columns=self.newton)
            e_out[:, s:e] = share * e_pair.sum(-1)
            if self.use_gb:
                b_out[:, s:e] += db_row.sum(-1)
                if self.newton:
                    b_out.index_add_(1, cols, db_col.sum(-2))
        return e_out, b_out.to(x.dtype)

    def pair_forces_reference(self, x: torch.Tensor, B: torch.Tensor,
                              c: torch.Tensor, close=None) -> torch.Tensor:
        """Pair forces ``(R, N, 3)`` (twin of the force kernels)."""
        x = self._batch(x)
        out = torch.zeros_like(x)
        for s, e, cols, d, r, one in self._blocks(x, close):
            Wd = self.pair_force_terms(B, c, s, e, cols, d, r, one)
            out[:, s:e] -= Wd.sum(-2)
            if self.newton:
                # Newton's third law: +W d on the column atom
                out.index_add_(1, cols, Wd.sum(1))
        return out

    def pair_force_terms(self, B, c, s, e, cols, d, r, one) -> torch.Tensor:
        """``(W / r) d (R, e - s, m, 3)``: the force that the column atoms
        ``cols`` (``None``: all) put on the row atoms s:e is ``-sum`` of it
        over the columns, and the row atoms' on the columns ``+sum`` over the
        rows. ``d`` are the separations ``x_row - x_col``, ``r`` the
        distances and ``one`` the mask of the pairs to count."""
        inv_r = 1.0 / r
        ob = self._band_mask(s, e, cols).to(d.dtype)
        sr6 = _sr6(0.5 * (self.sig[s:e, None] + self._at(self.sig, cols)[None, :]), inv_r)
        eps = self.seps[s:e, None] * self._at(self.seps, cols)[None, :]
        qq = self.q[s:e, None] * self._at(self.q, cols)[None, :]
        W = (4.0 * eps * (-12.0 * sr6 * sr6 + 6.0 * sr6) * inv_r
             - self.ke * qq * inv_r * inv_r) * ob
        if self.use_gb:
            Bi = B[:, s:e, None]
            Bj = self._at(B, cols)[:, None, :]
            BB = Bi * Bj
            rsq = r * r
            expu = torch.exp(-rsq / (4.0 * BB))
            inv_f = 1.0 / torch.sqrt(rsq + BB * expu)
            dEdf = -(self.gb_pref * 2.0 * qq) * inv_f * inv_f
            W = W + dEdf * (r * (1.0 - 0.25 * expu) * inv_f)
            rho_j = self._at(self.rho, cols)[None, :]
            sr_j = self._at(self.sr, cols)[None, :]
            _, dH_ij = _hct(r, inv_r, self.rho[s:e, None], sr_j, value=False)
            _, dH_ji = _hct(r, inv_r, rho_j, self.sr[s:e, None], value=False)
            dI_ij = 0.5 * dH_ij
            dI_ji = 0.5 * dH_ji
            if self.use_neck:
                d0, m0 = self._neck_tables(s, e, cols)
                _, dnv = _neck(r, d0, m0)
                dI_ij = dI_ij + dnv
                dI_ji = dI_ji + dnv
            W = W + c[:, s:e, None] * dI_ij + self._at(c, cols)[:, None, :] * dI_ji
        return (W * one * inv_r)[..., None] * d

    # --- the kernels ---------------------------------------------------------------

    def _check_cuda(self, what: str, x, *per_atom):
        """Device, type, layout and shape of a launch's inputs: ``x (R, N,
        3)`` and per-atom ``(R, N)`` tensors."""
        for t in per_atom:
            if tuple(t.shape) != tuple(x.shape[:2]):
                raise ValueError(f"{what}: per-atom input {tuple(t.shape)} "
                                 f"does not match x {tuple(x.shape)}")
        for t in (x, *per_atom):
            if t.device.type != "cuda" or t.device != x.device:
                raise RuntimeError(f"{what} runs on CUDA tensors, got {t.device}")
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise TypeError(f"{what} takes contiguous float32 tensors")
        if self.mode != "dense" and self.tile % ROW_BLOCK:
            raise ValueError(
                f"{what}: the {self.mode} kernels take tiles that are multiples of "
                f"{ROW_BLOCK} atoms, got tile={self.tile}")
        if self.n_tiles > 65535:
            raise ValueError(f"{what}: {self.n_tiles} tiles exceed the grid's 65,535")

    def _close_table(self, what: str, x, close):
        """``close`` as the kernels read it: ``(R, G, G)`` bytes, from the
        stored positions ``x`` when not given; ``None`` without a cutoff."""
        if self.gb_cutoff is None:
            return None
        if close is None:
            close = self.close_tiles(x)
        close = close.contiguous().view(torch.uint8)   # bool is one byte
        if tuple(close.shape) != (x.shape[0], self.n_tiles, self.n_tiles):
            raise ValueError(f"{what}: close table {tuple(close.shape)}")
        return close

    def patch_list(self, xs: torch.Tensor, close=None) -> torch.Tensor:
        """The Newton kernels' work list at the stored positions ``xs (R, N,
        3)`` on the card: the 32 x 32 patches of 32-atom groups (row group,
        column group at or after it) of the tile blocks ``close`` keeps
        (``close_tiles(xs)`` when not given) whose groups' bounding boxes
        are within the cutoff (every patch without one), built on the
        device, with the groups' boxes beside it. Pass it as ``patches=``
        to the three sweeps of the same positions, as ``__call__`` does;
        a sweep called without one builds its own."""
        name = "pair_newton_list"
        self._check_cuda(name, xs)
        if not self.newton:
            raise ValueError(f"{name}: only the Newton kernels walk a patch list")
        R, n = xs.shape[0], xs.shape[1]
        close = self._close_table(name, xs, close)
        lib = _library()
        work = torch.empty(lib.pmarlo_pair_newton_work_size(R, n), dtype=torch.int64,
                           device=xs.device)
        rc = lib.pmarlo_pair_newton_list(
            xs.data_ptr(), None if close is None else close.data_ptr(), R, n, self.tile,
            self._cut_r2, int(self.gb_cutoff is not None), work.data_ptr(),
            torch.cuda.current_stream(xs.device).cuda_stream)
        _kernels.check_launch(rc, name)
        return work

    def _launch(self, sweep: str, x, B=None, c=None, close=None, patches=None):
        """One sweep of this object's mode on the card: ``born`` gives
        ``I (R, N)``, ``energy`` ``(e_rows float64, dEdB)``, ``force``
        ``F (R, N, 3)``. ``patches``: the Newton sweeps' ``patch_list`` of
        these positions (built here when not given)."""
        name = kernel_name(sweep, self.mode)
        self._check_cuda(name, x, *(t for t in (B, c) if t is not None))
        lib = _library()
        R, n = x.shape[0], x.shape[1]
        if self.mode == "dense":
            need = dense_scratch(sweep, R, n)[2]
            limit = torch.cuda.get_device_properties(x.device).total_memory // 4
            if need > limit:
                raise ValueError(
                    f"{name}: the dense sweep's slot scratch for R={R}, N={n} takes "
                    f"{need / 2**30:.1f} GiB, more than a quarter of the card's memory "
                    f"({limit / 2**30:.1f} GiB); evaluate fewer replicas a call, or "
                    f"use gb_cutoff")
        # the Newton kernels add into their outputs
        new = torch.zeros if self.newton else torch.empty
        shape = (R, n, 3) if sweep == "force" else (R, n)
        out0 = new(shape, dtype=torch.float32, device=x.device)
        rows = (new((R, n), dtype=torch.float64, device=x.device)
                if sweep == "energy" else None)
        code = _SWEEPS.index(sweep)
        stream = torch.cuda.current_stream(x.device).cuda_stream

        def ptr(t):
            return None if t is None else t.data_ptr()

        atoms = (x.data_ptr(), self._atom_p.data_ptr(), self._cls.data_ptr(),
                 self._orig.data_ptr(), self._d0c_k.data_ptr(), self._m0c_k.data_ptr(),
                 self._d0c_k.shape[0], ptr(B), ptr(c))
        terms = (self.band_D, self.ke, self.gb_pref, self._cut_r2)
        flags = (int(self.use_gb), int(self.use_neck), out0.data_ptr(), ptr(rows))
        if self.newton:
            if patches is None:
                patches = self.patch_list(x, close)
            elif (patches.device != x.device or patches.dtype != torch.int64
                  or patches.numel() != lib.pmarlo_pair_newton_work_size(R, n)):
                raise ValueError(f"{name}: patches are not a patch list of R={R}, N={n}")
            rc = lib.pmarlo_pair_newton_sweep(code, *atoms, R, n, *terms,
                                              int(self.gb_cutoff is not None), *flags,
                                              patches.data_ptr(), stream)
        else:
            close = self._close_table(name, x, close)
            # the dense sweeps' per-slot partials (dense_scratch), the
            # culled sweeps' boxes and slots (culled_scratch)
            if self.mode == "dense":
                shape, dtype, _ = dense_scratch(sweep, R, n)
                slots = torch.empty(shape, dtype=dtype, device=x.device)
            else:
                slots = torch.empty(culled_scratch(sweep, R, n), dtype=torch.uint8,
                                    device=x.device)
            rc = lib.pmarlo_pair_sweep(code, _MODES.index(self.mode), *atoms, ptr(close), R, n,
                                       self.tile, *terms, *flags, ptr(slots), stream)
        _kernels.check_launch(rc, name)
        launches[name] += 1
        return (rows, out0) if sweep == "energy" else out0

    # --- per-sweep entry points: the twin on the CPU, the kernel on CUDA ----------
    # ``patches``: a Newton ``patch_list`` of the same positions, which the
    # kernel walks instead of building its own (the plain versions need none)

    def born(self, x: torch.Tensor, close=None, patches=None) -> torch.Tensor:
        x = self._batch(x)
        if x.device.type == "cpu":
            return self.born_reference(x, close)
        return self._launch("born", x.contiguous(), close=close, patches=patches)

    def energy_rows(self, x: torch.Tensor, B: torch.Tensor, close=None, patches=None):
        x = self._batch(x)
        if x.device.type == "cpu":
            return self.energy_rows_reference(x, B, close)
        return self._launch("energy", x.contiguous(), B.contiguous(), close=close,
                            patches=patches)

    def pair_forces(self, x: torch.Tensor, B: torch.Tensor, c: torch.Tensor, close=None,
                    patches=None):
        x = self._batch(x)
        if x.device.type == "cpu":
            return self.pair_forces_reference(x, B, c, close)
        return self._launch("force", x.contiguous(), B.contiguous(), c.contiguous(),
                            close=close, patches=patches)

    # --- glue, correction, assembly -------------------------------------------------

    def born_radii(self, I: torch.Tensor):
        """``(B, dB/dpsi)`` from the Born integral; dB/dpsi is zero where
        1/B is clamped at 1e-3."""
        psi = I * self.rho
        g = self.ab * psi - self.bb * psi * psi + self.gb * psi**3
        t = torch.tanh(g)
        inv_B_raw = 1.0 / self.rho - t / self.radii
        B = 1.0 / torch.clamp(inv_B_raw, min=1e-3)
        gprime = self.ab - 2.0 * self.bb * psi + 3.0 * self.gb * psi * psi
        dB = B * B * (1.0 - t * t) * gprime / self.radii
        return B, torch.where(inv_B_raw < 1e-3, torch.zeros_like(dB), dB)

    def gb_terms(self, B, dB, dEdB_pair):
        """Self and surface-area energies ``(R,)`` and the Born chain
        coefficients ``c = dE/dB dB/dpsi rho (R, N)`` that the force sweep
        takes; the factor 2 counts B_i in both ordered pair directions."""
        inv_B = 1.0 / B
        q2 = self.q * self.q
        energy = ((self.gb_pref * q2 * inv_B).sum(-1, dtype=torch.float64)
                  + (self.sa * inv_B**6).sum(-1, dtype=torch.float64))
        dEdB = (2.0 * dEdB_pair - self.gb_pref * q2 * inv_B * inv_B
                - 6.0 * self.sa * inv_B**7)
        return energy, dEdB * dB * self.rho

    def correction(self, x: torch.Tensor):
        """Band add-back and far-pair correction on positions in the
        caller's order: energies ``(R,)`` and forces ``(R, N, 3)``. With a
        cutoff a band or far pair beyond it is wanted at exactly zero, as
        the sweeps count it."""
        x = self._batch(x)
        if self._corr_i.numel() == 0:
            return x.new_zeros(x.shape[0], dtype=torch.float64), torch.zeros_like(x)
        d = x[:, self._corr_i] - x[:, self._corr_j]
        r = torch.sqrt((d * d).sum(-1) + _EPS)
        inv_r = 1.0 / r
        sr6 = _sr6(self._corr_sig, inv_r)
        el = self._corr_el * inv_r
        e_pair = self._corr_lj * (sr6 * sr6 - sr6) + el
        dEdr = (self._corr_lj * (-12.0 * sr6 * sr6 + 6.0 * sr6) - el) * inv_r
        if self.gb_cutoff is not None:
            within = cutoff_pairs(d, self.gb_cutoff).to(x.dtype)
            e_pair = e_pair * within
            dEdr = dEdr * within
        energy = e_pair.sum(-1, dtype=torch.float64)
        f_i = -(dEdr * inv_r)[..., None] * d
        return energy, self._corr_rows(f_i, -f_i)

    def bonded_reference(self, x: torch.Tensor):
        """Bonded energies ``(R,)`` float64 and forces ``(R, N, 3)`` by
        index gathers."""
        return bonded_energy_and_forces(self._bonded, x, energy_dtype=torch.float64)

    def bonded_terms(self, x: torch.Tensor):
        """The same from the bonded kernel with ``bonded="window"`` (a system
        without bonded terms has no kernel, and the gathers give zeros)."""
        if self._bonded_kernel is None:
            return self.bonded_reference(x)
        energy, grad = self._bonded_kernel(x, energy_dtype=torch.float64)
        return energy, -grad

    def _evaluate(self, x, born, energy_rows, pair_forces, bonded_terms, share_list=False):
        """Energy and forces from the given sweeps; ``share_list``: build
        the Newton kernels' ``patch_list`` once and hand it to the three."""
        lead = tuple(x.shape[:-2])
        xb = self._batch(x.reshape((-1,) + tuple(x.shape[-2:])))
        xs = self.to_storage(xb).contiguous()
        close = self.close_tiles(xs)
        kw = {"patches": self.patch_list(xs, close)} if share_list else {}
        if self.use_gb:
            B, dB = self.born_radii(born(xs, close, **kw))
        else:
            B = torch.ones(xs.shape[:2], dtype=xs.dtype, device=xs.device)
        e_rows, dEdB_pair = energy_rows(xs, B, close, **kw)
        energy = e_rows.sum(-1)
        if self.use_gb:
            e_gb, c = self.gb_terms(B, dB, dEdB_pair)
            energy = energy + e_gb
        else:
            c = torch.zeros_like(B)
        forces = self.from_storage(pair_forces(xs, B, c, close, **kw))
        e_c, f_c = self.correction(xb)
        e_b, f_b = bonded_terms(xb)
        energy = (energy + e_c + e_b).to(xb.dtype)
        forces = forces + f_c + f_b
        return energy.reshape(lead), forces.reshape(tuple(x.shape))

    def __call__(self, x: torch.Tensor):
        """Energy and forces: the kernels on a CUDA tensor, the twins on a
        CPU tensor."""
        return self._evaluate(x, self.born, self.energy_rows, self.pair_forces,
                              self.bonded_terms,
                              share_list=self.newton and x.device.type == "cuda")

    def reference(self, x: torch.Tensor):
        """The plain twin of the whole evaluation, on any device (the
        bonded terms by the index gathers)."""
        return self._evaluate(x, self.born_reference, self.energy_rows_reference,
                              self.pair_forces_reference, self.bonded_reference)

    @property
    def launches(self) -> dict:
        """Kernel launches of this process by kernel name (module-wide)."""
        return launches


def build_pair_force_fn(
    system: System,
    *,
    tile: int = 128,
    gb_cutoff: Optional[float] = None,
    order_from=None,
    newton: Optional[bool] = None,
    bonded: str = "auto",
    band: Optional[ExclusionBand] = None,
    dtype: torch.dtype = torch.float32,
) -> PairForce:
    """The pair force function of ``system`` (tensors on ``system.device``),
    with the arguments of ``pallas_pair.build_pair_force_fn``.

    ``gb_cutoff`` (nm) cuts every pair term (LJ, Coulomb, GB cross term,
    Born descreening, neck) at ``r > gb_cutoff`` and skips tile blocks whose
    bounding boxes are farther apart: the path for large assemblies, for
    thermostatted dynamics only (the force jumps at the cutoff).
    ``order_from`` (positions ``(N, 3)``) stores the atoms in a Morton order
    of that geometry, so that tiles are compact; it needs ``gb_cutoff``.
    ``newton`` picks the kernels that compute each unordered tile block once
    (default: with ``gb_cutoff``); they also run without a cutoff, over the
    whole upper triangle. ``bonded`` is ``"gather"`` (index gathers),
    ``"window"`` (the bonded kernel of ``md/bonded_window.py``) or
    ``"auto"``: the kernel with ``gb_cutoff`` from 8,192 atoms up.

    ``tile`` is the row chunk of the plain twins (their memory is
    O(tile * N) a sweep) and, with ``gb_cutoff`` or ``newton``, the atoms a
    tile: a multiple of 32 on the card.
    ``dtype=torch.float64`` gives a float64 twin (a precision reference; the
    kernels take float32 only). ``band`` overrides the exclusion band built
    from the system (``ExclusionBand.from_numpy`` carries JAX's)."""
    if order_from is not None and gb_cutoff is None:
        raise ValueError("order_from only affects the gb_cutoff path")
    if newton is None:
        newton = gb_cutoff is not None
    if bonded not in ("auto", "gather", "window"):
        raise ValueError(f"bonded must be auto|gather|window, got {bonded!r}")
    if bonded == "auto":
        # the kernel takes float32: a float64 twin keeps the gathers
        bonded = ("window" if gb_cutoff is not None and system.n_atoms >= 8192
                  and dtype == torch.float32 else "gather")
    perm = None
    if order_from is not None:
        x0 = (order_from.detach().cpu().numpy() if isinstance(order_from, torch.Tensor)
              else np.asarray(order_from))
        if x0.shape != (system.n_atoms, 3):
            raise ValueError("order_from must provide one position per atom")
        perm = _morton_order(x0)
    return PairForce(system, tile=tile, band=band, dtype=dtype, gb_cutoff=gb_cutoff,
                     perm=perm, newton=newton, bonded=bonded)


__all__ = ["PairForce", "build_pair_force_fn", "launches", "kernel_name", "cutoff_pairs",
           "cutoff_r2", "tile_boxes", "tiles_within", "dense_scratch", "culled_scratch",
           "culled_force_scratch", "MAX_CLASSES", "FORCE_TILE", "CULLED_SEGMENTS"]
