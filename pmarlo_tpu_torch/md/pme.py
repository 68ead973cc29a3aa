"""Smooth particle-mesh Ewald electrostatics for the periodic path.

Port of ``pmarlo_tpu/md/pme.py``, plain PyTorch (the JAX package leaves it
all to XLA; no kernel of its own):

* real space: ke q_i q_j erfc(alpha r) / r inside the cutoff, computed by
  the cell-list sweep in its Ewald mode (``md/cell_force.py``) or by the
  dense oracle here;
* reciprocal space: smooth PME (Essmann et al. 1995), cardinal B-spline
  charge spreading onto a (K1, K2, K3) grid, ``torch.fft.rfftn`` in
  complex64, the influence function exp(-pi^2 m^2 / alpha^2) / m^2 with
  the B-spline deconvolution |b1 b2 b3|^2;
* self energy, net-charge background and the excluded-pair correction.

Forces come from autograd of the reciprocal energy, as in JAX.

**Spreading.** JAX builds dense (N, K) one-hot weight matrices and spreads
by one matmul a z-plane, because the TPU's matrix unit likes it. Here each
atom's ``order``^3 weights go onto the flattened grid with one
``index_add_`` (its autograd backward is a gather). On the CPU the sums are
ordered; on a card ``index_add_`` adds with atomics, so two evaluations of
the same positions can differ in the last bits of the mesh energy and
forces (``chip_smoke.py`` phase 19 reads that difference run to run, as
phase 15 does for the Newton sweeps).

**Boxes.** ``box`` is a host triple (a static box: the influence function
is built once in float64 and kept) or a (3,) float32 tensor (the NPT path:
the influence function, the volume and the fractional coordinates follow
the box on the device, with no host read). A triclinic box that changes
takes ``tilt_ratios`` (``md/box.py traced_matrices``). The B-spline moduli
depend on K only and are built once a mesh (``ReciprocalMesh``).

``spread_charges_precise`` carries the fractional coordinates and the
spline recursion in df32 (``md/eft.py``), float32 pairs, as JAX does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import host_constant
from ..constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 as KE

SPLINE_ORDER = 4
#: default real-space mesh spacing per spline order (nm)
SPACING_BY_ORDER = {4: 0.11, 6: 0.145}
#: h * alpha per order, calibrated at alpha = 2.9203 (rc 0.9 nm, tol 5e-4)
_MESH_CALIBRATION = {o: h * 2.9202898720871846
                     for o, h in SPACING_BY_ORDER.items()}


def _box_tensor(box, like: torch.Tensor) -> torch.Tensor:
    """A box tensor as it is, or a host box as a cached constant."""
    if isinstance(box, torch.Tensor):
        return box.to(dtype=like.dtype, device=like.device)
    return host_constant(box, like)


def pme_spacing(order: int, alpha: float) -> float:
    """Mesh spacing (nm) holding reciprocal accuracy constant as alpha
    varies: h = (h_cal * alpha_cal) / alpha."""
    return _MESH_CALIBRATION[order] / alpha


def ewald_alpha(cutoff: float, tolerance: float = 5e-4) -> float:
    """OpenMM's alpha choice: erfc(alpha rc)/rc ~ tolerance
    (NonbondedForce ewaldErrorTolerance semantics)."""
    return math.sqrt(-math.log(2.0 * tolerance)) / cutoff


def pme_grid_shape(
    box: Tuple[float, float, float], spacing: float = 0.11
) -> Tuple[int, int, int]:
    """Mesh dims: ~``spacing`` nm, rounded up to a multiple of 8, at least
    16."""
    def dim(L):
        k = int(np.ceil(L / spacing))
        return max(((k + 7) // 8) * 8, 16)

    return tuple(dim(float(L)) for L in box)


def _mn_integer(order: int) -> np.ndarray:
    """Cardinal B-spline M_n at the integers 1..n-1 (host, Cox-de Boor)."""
    u = np.arange(1, order, dtype=np.float64)
    M = np.maximum(1.0 - np.abs(u - 1.0), 0.0)          # M_2(u)
    for n in range(3, order + 1):
        M = (u * M + (n - u) * np.concatenate([[0.0], M[:-1]])) / (n - 1)
    return M


def _bspline_weights(t: torch.Tensor, order: int) -> torch.Tensor:
    """Cardinal B-spline M_order weights ``(..., order)`` of the fractional
    offsets ``t`` in [0, 1), for the grid points floor(u) - 1 + k."""
    if order == 4:
        w0 = (1.0 - t) ** 3 / 6.0
        w1 = (3.0 * t**3 - 6.0 * t**2 + 4.0) / 6.0
        w2 = (-3.0 * t**3 + 3.0 * t**2 + 3.0 * t + 1.0) / 6.0
        w3 = t**3 / 6.0
        return torch.stack([w0, w1, w2, w3], dim=-1)
    # M_order(t + k) on the ascending samples u_k = t + k (the recursion's
    # M_{n-1}(u - 1) is a right shift), flipped to w[j] = M(t + order-1-j)
    offs = torch.arange(order, dtype=t.dtype, device=t.device)
    u = t[..., None] + offs
    M = torch.clamp(1.0 - torch.abs(u - 1.0), min=0.0)    # M_2
    for n in range(3, order + 1):
        M_shift = torch.cat([torch.zeros_like(M[..., :1]), M[..., :-1]], dim=-1)
        M = (u * M + (n - u) * M_shift) / (n - 1)
    return torch.flip(M, dims=(-1,))


def _bspline_bsq(K: int, order: int = SPLINE_ORDER) -> np.ndarray:
    """|b(m)|^2 deconvolution factors for order-n splines on a K grid
    (Essmann eq. 4.4), float64."""
    m = np.arange(K)
    M = _mn_integer(order)
    denom = np.zeros(K, dtype=np.complex128)
    for k in range(order - 1):
        denom += M[k] * np.exp(2j * np.pi * m * k / K)
    return 1.0 / np.maximum(np.abs(denom) ** 2, 1e-14)


def _bspline_weights_df(t_hi: torch.Tensor, t_lo: torch.Tensor, order: int):
    """The Cox-de Boor recursion in df32: ``(hi, lo)`` weights ``(...,
    order)`` in the layout of ``_bspline_weights``."""
    from .eft import df_abs, df_add, df_const, df_max0, df_mul, df_scale, df_sub

    offs = torch.arange(order, dtype=t_hi.dtype, device=t_hi.device)
    shape = tuple(t_hi.shape) + (order,)
    # u_k = t + k as df32 (t_hi + k rounds past 24 bits, so two_sum it)
    u = df_add((t_hi[..., None] + torch.zeros_like(offs),
                t_lo[..., None] + torch.zeros_like(offs)),
               (offs.expand(shape), torch.zeros(shape, dtype=t_hi.dtype, device=t_hi.device)))
    one = (torch.ones_like(u[0]), torch.zeros_like(u[0]))
    M = df_max0(df_sub(one, df_abs(df_sub(u, one))))        # M_2(u)
    for n in range(3, order + 1):
        M_shift = tuple(torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], dim=-1)
                        for m in M)
        n_df = (torch.full_like(u[0], float(n)), torch.zeros_like(u[0]))
        term = df_add(df_mul(u, M), df_mul(df_sub(n_df, u), M_shift))
        M = df_scale(term, *df_const(1.0 / (n - 1)))
    return torch.flip(M[0], dims=(-1,)), torch.flip(M[1], dims=(-1,))


def _S_df_traced(box: torch.Tensor, ratios, shape: Tuple[int, int, int]):
    """(Sh, Sl) split of S = Hinv diag(K) for a (3,) box tensor and static
    tilt ratios (``md/box.py traced_matrices``: u = x Hinv, Hinv lower
    triangular). Only 1/L_i needs df precision (``df_inv``)."""
    from .eft import df_const, df_inv, df_scale

    r1, r2, r3 = (float(r) for r in ratios)
    K1, K2, K3 = (float(k) for k in shape)
    ia, ib, ic = df_inv(box[0]), df_inv(box[1]), df_inv(box[2])
    z = torch.zeros_like(box[0])

    def ent(inv, coef):
        return df_scale(inv, *df_const(coef))

    # nonzero S entries (traced_matrices' Hinv): S[i, j] = Hinv[i, j] K_j
    e00 = ent(ia, K1)
    e10 = ent(ib, -r1 * K1)
    e11 = ent(ib, K2)
    e20 = ent(ic, (r1 * r3 - r2) * K1)
    e21 = ent(ic, -r3 * K2)
    e22 = ent(ic, K3)

    def mat(k):
        return torch.stack([
            torch.stack([e00[k], z, z]),
            torch.stack([e10[k], e11[k], z]),
            torch.stack([e20[k], e21[k], e22[k]]),
        ])

    return mat(0), mat(1)


def _frac_coords_df(x: torch.Tensor, S=None, Sh=None, Sl=None):
    """u = x S in df32, ``x (..., N, 3)``. Either ``S`` (host float64 S =
    Hinv diag(K), static boxes) or its split (``Sh``, ``Sl``) as tensors
    (``_S_df_traced``). Returns (u0 int64 floor, t_hi, t_lo) per axis, the
    fractional part accurate to ~float32 eps absolute."""
    from .eft import df_add, fast_two_sum, two_prod, two_sum

    if S is not None:
        Sh32 = np.float32(S)
        Sh = host_constant(Sh32, x, torch.float32)
        Sl = host_constant(np.float32(S - np.float64(Sh32)), x, torch.float32)
    uh = torch.zeros_like(x)
    ul = torch.zeros_like(x)
    for j in range(3):
        xj = x[..., j:j + 1]
        ph, pe = two_prod(xj, Sh[j])
        pe = pe + xj * Sl[j]
        uh, ul = df_add((uh, ul), fast_two_sum(ph, pe))
    u0 = torch.floor(uh)
    th, tl = two_sum(uh - u0, ul)   # uh - u0 exact (integer subtraction)
    # renormalize the rare boundary spill into [0, 1)
    under = (th < 0).to(x.dtype)
    over = (th >= 1.0).to(x.dtype)
    u0 = u0 + over - under
    th = th + under - over
    return u0.to(torch.int64), th, tl


def _spread(u0: torch.Tensor, weights, q: torch.Tensor,
            shape: Tuple[int, int, int]) -> torch.Tensor:
    """Q ``(..., K1, K2, K3)``: atom n adds q_n wx[a] wy[b] wz[c] at grid
    point ((u0x - 1 + a) mod K1, (u0y - 1 + b) mod K2, (u0z - 1 + c) mod
    K3), all ``order``^3 points of all atoms by one ``index_add_``.
    ``u0 (..., N, 3)`` int64, ``weights`` three ``(..., N, order)``."""
    K1, K2, K3 = shape
    lead = tuple(u0.shape[:-2])
    n = u0.shape[-2]
    B = int(np.prod(lead)) if lead else 1
    wx, wy, wz = (w.reshape(B, n, -1) for w in weights)
    order = wx.shape[-1]
    offs = torch.arange(order, device=u0.device) - 1
    cols = [torch.remainder(u0.reshape(B, n, 3)[..., a, None] + offs, K)
            for a, K in enumerate(shape)]                        # (B, N, order)
    flat = ((cols[0][..., :, None, None] * K2 + cols[1][..., None, :, None]) * K3
            + cols[2][..., None, None, :])                       # (B, N, o, o, o)
    flat = flat + (torch.arange(B, device=u0.device) * (K1 * K2 * K3))[:, None, None,
                                                                       None, None]
    wzq = wz * q[:, None]
    vals = (wx[..., :, None, None] * wzq[..., None, None, :]) * wy[..., None, :, None]
    Q = torch.zeros(B * K1 * K2 * K3, dtype=vals.dtype, device=vals.device)
    Q = Q.index_add(0, flat.reshape(-1), vals.reshape(-1))
    return Q.reshape(lead + (K1, K2, K3))


def _axis_weights(u: torch.Tensor, order: int):
    u0 = torch.floor(u)
    return u0.to(torch.int64), _bspline_weights(u - u0, order)


def spread_charges(
    x: torch.Tensor, q: torch.Tensor,
    box,
    shape: Tuple[int, int, int],
    order: int = SPLINE_ORDER,
    tilt: Optional[Tuple[float, float, float]] = None,
    tilt_ratios: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """The charge grid ``(..., K1, K2, K3)`` of ``x (..., N, 3)`` with
    M_order spline weights, differentiable in ``x``. ``tilt``: triclinic
    off-diagonals of a static box; ``tilt_ratios``: the triclinic form of a
    box tensor (isotropic moves keep the ratios). The mesh lives in
    fractional coordinates, so a triclinic cell is another ``u`` map."""
    Ks = host_constant(shape, x)
    if tilt_ratios is not None:
        from .box import traced_matrices

        _, Hinv = traced_matrices(_box_tensor(box, x), tilt_ratios)
        u = torch.matmul(x, Hinv) * Ks
    elif tilt is None:
        u = x / _box_tensor(box, x) * Ks
    else:
        from .box import box_matrix

        u = torch.matmul(x, host_constant(np.linalg.inv(box_matrix(box, tilt)), x)) * Ks
    u0, w = _axis_weights(u, order)
    return _spread(u0, [w[..., a, :] for a in range(3)], q, shape)


def spread_charges_precise(
    x: torch.Tensor, q: torch.Tensor,
    box,
    shape: Tuple[int, int, int],
    order: int = SPLINE_ORDER,
    tilt: Optional[Tuple[float, float, float]] = None,
    tilt_ratios: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """Compensated-precision spreading: the fractional coordinates and the
    spline weights in df32 (``md/eft.py``). The float32 path loses log2(K)
    mantissa bits in ``t = u - floor(u)`` and ~2 ulp in the recursion; the
    df recursion's hi limb is the correctly rounded float32 weight, which
    is what is spread. A box tensor (NPT) builds the df32 split of S = Hinv
    diag(K) on the device (``_S_df_traced``)."""
    K1, K2, K3 = shape
    if isinstance(box, torch.Tensor) or tilt_ratios is not None:
        Sh, Sl = _S_df_traced(_box_tensor(box, x), tilt_ratios or (0.0, 0.0, 0.0), shape)
        u0, th, tl = _frac_coords_df(x, Sh=Sh, Sl=Sl)
    else:
        if tilt is None:
            H = np.diag(np.asarray(box, np.float64))
        else:
            from .box import box_matrix

            H = np.asarray(box_matrix(box, tilt), np.float64)
        S = np.linalg.inv(H) @ np.diag(np.asarray([K1, K2, K3], np.float64))
        u0, th, tl = _frac_coords_df(x, S)
    weights = [_bspline_weights_df(th[..., a], tl[..., a], order)[0] for a in range(3)]
    return _spread(u0, weights, q, shape)


class ReciprocalMesh:
    """The parts of the reciprocal sum that depend on the mesh only, built
    once: the B-spline moduli and the integer frequencies of the
    ``rfftn`` half grid (K1, K2, K3 // 2 + 1), and each static box's
    influence function (float64 on the host, kept as float32). The half
    grid holds every m3 >= 0; the terms with 0 < m3 < K3 / 2 stand for
    their mirror images too (|F(-m)| = |F(m)| for a real grid), so they
    are counted twice."""

    def __init__(self, shape: Tuple[int, int, int], order: int, alpha: float, device):
        self.shape = tuple(int(k) for k in shape)
        self.order = int(order)
        self.alpha = float(alpha)
        self.device = torch.device(device)
        K1, K2, K3 = self.shape
        h = K3 // 2 + 1
        self._m = (np.fft.fftfreq(K1) * K1, np.fft.fftfreq(K2) * K2,
                   np.fft.rfftfreq(K3) * K3)
        twice = np.full(h, 2.0)
        twice[0] = 1.0
        if K3 % 2 == 0:
            twice[-1] = 1.0
        self._B = (_bspline_bsq(K1, order)[:, None, None]
                   * _bspline_bsq(K2, order)[None, :, None]
                   * (_bspline_bsq(K3, order)[:h] * twice)[None, None, :])
        self._B32 = torch.as_tensor(self._B.astype(np.float32), device=self.device)
        self._m32 = [torch.as_tensor(m.astype(np.float32), device=self.device)
                     for m in self._m]
        self._static = {}

    def _static_influence(self, box, tilt):
        key = (tuple(float(b) for b in box), None if tilt is None else tuple(tilt))
        if key not in self._static:
            from .box import box_matrix

            Hi = np.linalg.inv(box_matrix(box, tilt))
            m1 = self._m[0][:, None, None]
            m2 = self._m[1][None, :, None]
            m3 = self._m[2][None, None, :]
            mx = Hi[0, 0] * m1
            my = Hi[1, 0] * m1 + Hi[1, 1] * m2
            mz = Hi[2, 0] * m1 + Hi[2, 1] * m2 + Hi[2, 2] * m3
            msq = mx * mx + my * my + mz * mz
            with np.errstate(divide="ignore", invalid="ignore"):
                infl = np.exp(-np.pi**2 * msq / self.alpha**2) / msq * self._B
            infl[0, 0, 0] = 0.0
            V = float(box[0]) * float(box[1]) * float(box[2])
            self._static[key] = (torch.as_tensor(infl.astype(np.float32), device=self.device),
                                 KE / (2.0 * np.pi * V))
        return self._static[key]

    def _traced_influence(self, box: torch.Tensor, tilt_ratios):
        """On the device from the (3,) box tensor, in float32."""
        from .box import traced_matrices

        box = box.to(torch.float32)
        _, Hi = traced_matrices(box, tilt_ratios or (0.0, 0.0, 0.0))
        m1 = self._m32[0][:, None, None]
        m2 = self._m32[1][None, :, None]
        m3 = self._m32[2][None, None, :]
        mx = Hi[0, 0] * m1
        my = Hi[1, 0] * m1 + Hi[1, 1] * m2
        mz = Hi[2, 0] * m1 + Hi[2, 1] * m2 + Hi[2, 2] * m3
        msq = mx * mx + my * my + mz * mz
        pos = msq > 0.0
        infl = torch.where(
            pos,
            torch.exp(-np.pi**2 * msq / self.alpha**2)
            / torch.where(pos, msq, torch.ones_like(msq)) * self._B32,
            torch.zeros_like(msq),
        )
        V = box[0] * box[1] * box[2]
        return infl, KE / (2.0 * np.pi * V)

    def energy(self, x: torch.Tensor, q: torch.Tensor, box, *,
               tilt: Optional[Tuple[float, float, float]] = None,
               tilt_ratios: Optional[Tuple[float, float, float]] = None,
               precise: bool = False) -> torch.Tensor:
        """Reciprocal energy ``(...)`` of ``x (..., N, 3)`` (Essmann eq.
        4.7): ke / (2 pi V) sum_{m != 0} exp(-pi^2 m^2 / alpha^2) / m^2
        B(m) |F[Q](m)|^2."""
        traced = isinstance(box, torch.Tensor)
        if tilt is not None and traced:
            raise NotImplementedError(
                "a box tensor takes tilt_ratios, not a static tilt "
                "(md/box.py tilt_ratios)")
        spread = spread_charges_precise if precise else spread_charges
        Q = spread(x, q, box, self.shape, self.order, tilt=tilt, tilt_ratios=tilt_ratios)
        F = torch.fft.rfftn(Q, dim=(-3, -2, -1))
        if traced or tilt_ratios is not None:
            infl, pref = self._traced_influence(_box_tensor(box, x), tilt_ratios)
        else:
            infl, pref = self._static_influence(box, tilt)
        power = F.real * F.real + F.imag * F.imag
        return pref * (infl * power).sum((-3, -2, -1))


def reciprocal_energy(
    x: torch.Tensor, q: torch.Tensor,
    box,
    alpha: float,
    shape: Tuple[int, int, int],
    order: int = SPLINE_ORDER,
    tilt: Optional[Tuple[float, float, float]] = None,
    tilt_ratios: Optional[Tuple[float, float, float]] = None,
    precise: bool = False,
) -> torch.Tensor:
    """Smooth-PME reciprocal energy of ``x (..., N, 3)`` (a fresh
    ``ReciprocalMesh``; callers that evaluate often keep one). ``box`` may
    be a (3,) tensor: the NPT path, the influence function built on the
    device."""
    return ReciprocalMesh(shape, order, alpha, x.device).energy(
        x, q, box, tilt=tilt, tilt_ratios=tilt_ratios, precise=precise)


def self_energy(q: torch.Tensor, alpha: float) -> torch.Tensor:
    return -KE * alpha / math.sqrt(math.pi) * torch.sum(q * q)


def background_energy(q: torch.Tensor, box, alpha: float) -> torch.Tensor:
    """Neutralizing-background term for net-charge cells. ``box`` may be a
    (3,) tensor (NPT: the term depends on the volume)."""
    if isinstance(box, torch.Tensor):
        V = box[0] * box[1] * box[2]
    else:
        V = float(box[0]) * float(box[1]) * float(box[2])
    return -KE * math.pi / (2.0 * alpha**2 * V) * torch.sum(q) ** 2


def _min_image(d: torch.Tensor, box, tilt):
    if tilt is None:
        L = torch.as_tensor(box, dtype=d.dtype, device=d.device)
        return d - L * torch.round(d / L)
    from .box import box_matrix, min_image_round

    H = box_matrix(box, tilt)
    return min_image_round(d, torch.as_tensor(H, dtype=d.dtype, device=d.device),
                           torch.as_tensor(np.linalg.inv(H), dtype=d.dtype, device=d.device))


def real_space_energy_dense(
    x: torch.Tensor, q: torch.Tensor,
    box: Tuple[float, float, float],
    cutoff: float, alpha: float,
    exclude_mask: Optional[torch.Tensor] = None,
    tilt: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """Dense oracle of the Ewald real-space sum of ``x (N, 3)`` (minimum
    image, erfc(alpha r)/r inside rc). ``exclude_mask (N, N)``: 1 for pairs
    to skip. Triclinic cells use the rounded fractional minimum image,
    exact for every r < cutoff when the perpendicular widths exceed 2
    cutoff (checked)."""
    if tilt is not None:
        from .box import box_matrix, perp_widths

        if float(np.min(perp_widths(box_matrix(box, tilt)))) <= 2.0 * float(cutoff):
            raise ValueError(
                "triclinic dense real-space sum needs min perpendicular "
                f"width > 2*cutoff; box {tuple(box)} tilt {tuple(tilt)} "
                f"vs cutoff {cutoff}"
            )
    d = _min_image(x[:, None, :] - x[None, :, :], box, tilt)
    r2 = torch.sum(d * d, dim=-1)
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    r = torch.sqrt(torch.where(r2 > 1e-12, r2, torch.ones_like(r2)))
    within = (r < cutoff).to(x.dtype) * (1.0 - eye)
    if exclude_mask is not None:
        within = within * (1.0 - exclude_mask)
    e = KE * q[:, None] * q[None, :] * torch.erfc(alpha * r) / r
    return 0.5 * torch.sum(e * within)


def excluded_pair_correction(
    x: torch.Tensor, q: torch.Tensor,
    box: Tuple[float, float, float],
    alpha: float,
    e_i: torch.Tensor, e_j: torch.Tensor, se: torch.Tensor,
    tilt: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """For pairs with electrostatic scale se < 1 the reciprocal sum counted
    a full erf(alpha r)/r interaction the force field does not want:
    subtract it and add the scaled bare Coulomb part (bounded as r -> 0)."""
    if e_i.shape[0] == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    d = _min_image(x[e_i] - x[e_j], box, tilt)
    r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    qq = q[e_i] * q[e_j]
    erf_term = KE * qq * torch.erf(alpha * r) / r
    bare = KE * qq / r
    return torch.sum(se * bare - erf_term)


def ewald_energy_dense(
    x: torch.Tensor, q: torch.Tensor,
    box: Tuple[float, float, float],
    cutoff: float,
    *,
    alpha: Optional[float] = None,
    shape: Optional[Tuple[int, int, int]] = None,
    tilt: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """Complete PME electrostatic energy with the dense real-space oracle:
    the validation path (Madelung constant) and the oracle the cell path's
    PME mode is held to."""
    a = ewald_alpha(cutoff) if alpha is None else alpha
    s = pme_grid_shape(mesh_lengths(box, tilt)) if shape is None else shape
    return (real_space_energy_dense(x, q, box, cutoff, a, tilt=tilt)
            + reciprocal_energy(x, q, box, a, s, tilt=tilt)
            + self_energy(q, a)
            + background_energy(q, box, a))


def mesh_lengths(box: Sequence[float], tilt) -> Tuple[float, float, float]:
    """The lattice-vector lengths a mesh resolves (the box diagonal of an
    orthorhombic cell)."""
    if tilt is None:
        return tuple(float(b) for b in box)
    from .box import box_matrix

    H = box_matrix(box, tilt)
    return tuple(float(np.linalg.norm(H[i])) for i in range(3))


__all__ = [
    "SPLINE_ORDER", "ReciprocalMesh", "background_energy", "ewald_alpha",
    "ewald_energy_dense", "excluded_pair_correction", "mesh_lengths", "pme_grid_shape",
    "pme_spacing", "real_space_energy_dense", "reciprocal_energy", "self_energy",
    "spread_charges", "spread_charges_precise",
]
