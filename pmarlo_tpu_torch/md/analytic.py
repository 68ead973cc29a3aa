"""Analytic energy + forces, batched over replicas (no autodiff).

Port of ``pmarlo_tpu/md/analytic.py``. The math is the JAX file's: manual
bond/angle/torsion derivatives, LJ/Coulomb pair coefficients, and the full
GB chain rule through the Born radii. What changes is the layout: bonded
gathers and scatters are indexed loads and ``index_add_`` where the JAX
code used one-hot selector matmuls, and positions carry leading replica
dimensions ``(..., N, 3)`` in place of ``vmap``.

This is the plain version of the fused kernel's force math
(``md/fused_md.py``, ``csrc/fused_md.cu``), and two choices here are the
kernel's as well:

- torsions are general, ``k (1 + cos(n phi - gamma))`` for any n and phase,
  with phi in the IUPAC sign of ``forces.dihedral_angles``. (The JAX
  analytic path takes the opposite sign, which only matters for phases
  other than 0 and pi.)
- where ``1/B`` is clamped at 1e-3 the Born radius is constant, so its
  derivative is zero: the force stays the exact gradient of the energy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
from .ff_params import OBC2_ALPHA, OBC2_BETA, OBC2_GAMMA
from .gbn2 import neck_value_and_derivative
from .system import System, require_dense_scales, require_no_vsites

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DenseParams:
    """System parameters pre-baked into dense tensors on one device."""

    # nonbonded pair matrices (N, N); diagonals zeroed
    qq_scaled: torch.Tensor    # ke * qi qj * scale_elec / eps_solute
    lj_a: torch.Tensor         # 4 eps sigma^12 * scale_lj
    lj_b: torch.Tensor         # 4 eps sigma^6  * scale_lj
    # GB
    q: torch.Tensor            # (N,)
    qq_full: torch.Tensor      # (N, N) gb_pref qi qj (no exclusions)
    gb_rho: torch.Tensor       # (N,) intrinsic radius - offset
    gb_sr: torch.Tensor        # (N,) screen * rho
    gb_radii: torch.Tensor     # (N,)
    sa_coef: torch.Tensor      # (N,) surface_tension * (R+probe)^2 * R^6
    gb_alpha: torch.Tensor     # (N,) tanh-rescale coefficients
    gb_beta: torch.Tensor
    gb_gamma: torch.Tensor
    # bonded terms: atom indices (int64) and parameters
    bond_idx: torch.Tensor     # (NB, 2)
    bond_k: torch.Tensor
    bond_r0: torch.Tensor
    angle_idx: torch.Tensor    # (NA, 3)
    angle_k: torch.Tensor
    angle_t0: torch.Tensor
    tor_idx: torch.Tensor      # (NT, 4)
    tor_k: torch.Tensor
    tor_n: torch.Tensor
    tor_phase: torch.Tensor
    masses: torch.Tensor       # (N,)
    gb_pref: float = 0.0       # -0.5 ke (1/eps_in - 1/eps_out)
    #: GBn2 neck lookup (None when neck_scale == 0)
    neck_d0: Optional[torch.Tensor] = None   # (N, N)
    neck_m0: Optional[torch.Tensor] = None   # (N, N), unscaled
    use_gb: bool = True
    neck_scale: float = 0.0

    @property
    def use_neck(self) -> bool:
        return self.use_gb and self.neck_scale != 0.0 and self.neck_m0 is not None


def _np64(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def make_dense_params(system: System, dtype=torch.float32) -> DenseParams:
    """Dense parameters on ``system.device`` (built in float64 on the host,
    as the JAX version builds them, then cast to ``dtype``)."""
    require_dense_scales(system, "the analytic dense force path")
    require_no_vsites(system, "the analytic dense force path")
    dev = system.device
    sigma = _np64(system.lj_sigma)
    eps = _np64(system.lj_eps)
    sigma_ij = 0.5 * (sigma[:, None] + sigma[None, :])
    eps_ij = np.sqrt(np.maximum(eps[:, None] * eps[None, :], 0.0))
    scale_l = _np64(system.scale_lj)
    scale_e = _np64(system.scale_elec)
    q = _np64(system.charges)
    ke = COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 / system.solute_dielectric
    qq_scaled = ke * np.outer(q, q) * scale_e
    np.fill_diagonal(qq_scaled, 0.0)
    lj_a = 4.0 * eps_ij * sigma_ij**12 * scale_l
    lj_b = 4.0 * eps_ij * sigma_ij**6 * scale_l
    np.fill_diagonal(lj_a, 0.0)
    np.fill_diagonal(lj_b, 0.0)

    gb_pref = (
        -0.5 * COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
        * (1.0 / system.solute_dielectric - 1.0 / system.solvent_dielectric)
    )
    radii = _np64(system.gb_radii)
    rho = radii - system.gb_offset
    sr = _np64(system.gb_screen) * rho
    n = len(radii)
    if system.gb_alpha is not None:
        gb_alpha = _np64(system.gb_alpha)
        gb_beta = _np64(system.gb_beta)
        gb_gamma = _np64(system.gb_gamma)
    else:
        gb_alpha = np.full(n, OBC2_ALPHA)
        gb_beta = np.full(n, OBC2_BETA)
        gb_gamma = np.full(n, OBC2_GAMMA)
    probe = 0.14
    sa_coef = system.surface_tension * (radii + probe) ** 2 * radii**6

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def idx(a):
        return a.to(device=dev, dtype=torch.long)

    return DenseParams(
        qq_scaled=t(qq_scaled), lj_a=t(lj_a), lj_b=t(lj_b),
        q=t(q), qq_full=t(gb_pref * np.outer(q, q)),
        gb_rho=t(rho), gb_sr=t(sr), gb_radii=t(radii), sa_coef=t(sa_coef),
        gb_alpha=t(gb_alpha), gb_beta=t(gb_beta), gb_gamma=t(gb_gamma),
        bond_idx=idx(system.bond_idx), bond_k=t(_np64(system.bond_k)),
        bond_r0=t(_np64(system.bond_r0)),
        angle_idx=idx(system.angle_idx), angle_k=t(_np64(system.angle_k)),
        angle_t0=t(_np64(system.angle_t0)),
        tor_idx=idx(system.torsion_idx), tor_k=t(_np64(system.torsion_k)),
        tor_n=t(_np64(system.torsion_n)),
        tor_phase=t(_np64(system.torsion_phase)),
        masses=t(_np64(system.masses)),
        gb_pref=float(gb_pref),
        neck_d0=(None if system.gb_neck_d0 is None
                 else t(_np64(system.gb_neck_d0))),
        neck_m0=(None if system.gb_neck_m0 is None
                 else t(_np64(system.gb_neck_m0))),
        use_gb=bool(system.use_gb),
        neck_scale=float(system.gb_neck_scale),
    )


def _dot(a, b):
    return (a * b).sum(-1)


def _bond_energy_forces(p: DenseParams, x, forces):
    x1 = x[..., p.bond_idx[:, 0], :]
    x2 = x[..., p.bond_idx[:, 1], :]
    d = x1 - x2
    r = torch.sqrt(_dot(d, d) + _EPS)
    dr = r - p.bond_r0
    energy = (0.5 * p.bond_k * dr * dr).sum(-1)
    f1 = -(p.bond_k * dr / r)[..., None] * d
    forces.index_add_(-2, p.bond_idx[:, 0], f1)
    forces.index_add_(-2, p.bond_idx[:, 1], -f1)
    return energy


def _angle_energy_forces(p: DenseParams, x, forces):
    xi = x[..., p.angle_idx[:, 0], :]
    xj = x[..., p.angle_idx[:, 1], :]
    xk = x[..., p.angle_idx[:, 2], :]
    u = xi - xj
    w = xk - xj
    lu = torch.sqrt(_dot(u, u) + _EPS)
    lw = torch.sqrt(_dot(w, w) + _EPS)
    nu = u / lu[..., None]
    nw = w / lw[..., None]
    cos_t = torch.clamp(_dot(nu, nw), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    dE = p.angle_k * (theta - p.angle_t0)              # dE/dtheta
    energy = (0.5 * p.angle_k * (theta - p.angle_t0) ** 2).sum(-1)
    # dtheta/dxi = (cos*nu - nw) / (lu sin); symmetric for xk
    gi = (cos_t[..., None] * nu - nw) / (lu * sin_t)[..., None]
    gk = (cos_t[..., None] * nw - nu) / (lw * sin_t)[..., None]
    fi = -dE[..., None] * gi
    fk = -dE[..., None] * gk
    forces.index_add_(-2, p.angle_idx[:, 0], fi)
    forces.index_add_(-2, p.angle_idx[:, 1], -(fi + fk))
    forces.index_add_(-2, p.angle_idx[:, 2], fk)
    return energy


def _torsion_energy_forces(p: DenseParams, x, forces):
    x1 = x[..., p.tor_idx[:, 0], :]
    x2 = x[..., p.tor_idx[:, 1], :]
    x3 = x[..., p.tor_idx[:, 2], :]
    x4 = x[..., p.tor_idx[:, 3], :]
    b1 = x2 - x1
    b2 = x3 - x2
    b3 = x4 - x3
    m = torch.cross(b1, b2, dim=-1)
    n = torch.cross(b2, b3, dim=-1)
    lb2 = torch.sqrt(_dot(b2, b2) + _EPS)
    m2 = _dot(m, m) + _EPS
    n2 = _dot(n, n) + _EPS
    # IUPAC sign, as forces.dihedral_angles: phi = atan2((m x n).b2hat, m.n)
    yy = _dot(torch.cross(m, n, dim=-1), b2) / lb2
    xx = _dot(m, n)
    phi = torch.atan2(yy, xx)
    arg = p.tor_n * phi - p.tor_phase
    energy = (p.tor_k * (1.0 + torch.cos(arg))).sum(-1)
    dE = -p.tor_k * p.tor_n * torch.sin(arg)           # dE/dphi
    # dphi/dx for this sign: d1 = -(|b2|/|m|^2) m ; d4 = (|b2|/|n|^2) n ;
    # d2 = -(1+s12) d1 + s32 d4 ; d3 = s12 d1 - (1+s32) d4
    d1 = -(lb2 / m2)[..., None] * m
    d4 = (lb2 / n2)[..., None] * n
    s12 = (_dot(b1, b2) / (lb2 * lb2))[..., None]
    s32 = (_dot(b3, b2) / (lb2 * lb2))[..., None]
    d2 = -(1.0 + s12) * d1 + s32 * d4
    d3 = s12 * d1 - (1.0 + s32) * d4
    c = -dE[..., None]
    forces.index_add_(-2, p.tor_idx[:, 0], c * d1)
    forces.index_add_(-2, p.tor_idx[:, 1], c * d2)
    forces.index_add_(-2, p.tor_idx[:, 2], c * d3)
    forces.index_add_(-2, p.tor_idx[:, 3], c * d4)
    return energy


def _nonbonded_energy_pair_coef(p: DenseParams, inv_r):
    """(energy, G) with G_ij = dE/dr_ij over ordered pairs / 2."""
    inv_r2 = inv_r * inv_r
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    inv_r12 = inv_r6 * inv_r6
    e_mat = p.lj_a * inv_r12 - p.lj_b * inv_r6 + p.qq_scaled * inv_r
    energy = 0.5 * e_mat.sum((-2, -1))
    dmat = (
        -12.0 * p.lj_a * inv_r12 * inv_r
        + 6.0 * p.lj_b * inv_r6 * inv_r
        - p.qq_scaled * inv_r2
    )
    return energy, 0.5 * dmat


def born_radii_and_chain(p: DenseParams, r, inv_r, one):
    """Born radii ``B (..., N)``, ``dB/dpsi`` and ``dI_i/dr_ij (..., N, N)``."""
    rho_i = p.gb_rho[:, None]
    sr_j = p.gb_sr[None, :]
    U_raw = r + sr_j
    # negative GBn2 sulfur screening can push U <= rho_i at close range;
    # such pairs are masked, and U is sanitized so log() stays finite
    inactive = U_raw <= rho_i
    U = torch.where(inactive, rho_i + 1.0, U_raw)
    absd = torch.abs(r - sr_j)
    sgn = torch.sign(r - sr_j)
    use_rho = absd < rho_i
    L = torch.where(use_rho, rho_i, absd)
    dL = torch.where(use_rho, torch.zeros_like(sgn), sgn)
    inv_L = 1.0 / L
    inv_U = 1.0 / U
    log_LU = torch.log(L * inv_U)
    quad = r - sr_j * sr_j * inv_r
    H = (
        inv_L - inv_U
        + 0.25 * quad * (inv_U * inv_U - inv_L * inv_L)
        + 0.5 * log_LU * inv_r
    )
    engulfed = (sr_j - r) > rho_i
    zero = torch.zeros_like(H)
    H = H + torch.where(engulfed, 2.0 * (1.0 / rho_i - inv_L), zero)
    active = (~inactive).to(r.dtype) * one
    I = 0.5 * (H * active).sum(-1)

    dquad = 1.0 + sr_j * sr_j * (inv_r * inv_r)
    dH = (
        -dL * inv_L * inv_L
        + inv_U * inv_U
        + 0.25 * dquad * (inv_U * inv_U - inv_L * inv_L)
        + 0.25 * quad * (-2.0 * inv_U**3 + 2.0 * dL * inv_L**3)
        - 0.5 * log_LU * inv_r * inv_r
        + 0.5 * inv_r * (dL * inv_L - inv_U)
    )
    dH = dH + torch.where(engulfed, 2.0 * dL * inv_L * inv_L, zero)
    dIdr = 0.5 * dH * active

    if p.use_neck:
        nv, dnv = neck_value_and_derivative(r, p.neck_d0, p.neck_m0)
        I = I + p.neck_scale * (nv * one).sum(-1)
        dIdr = dIdr + p.neck_scale * dnv * one

    psi = I * p.gb_rho
    g = p.gb_alpha * psi - p.gb_beta * psi**2 + p.gb_gamma * psi**3
    t = torch.tanh(g)
    inv_B_raw = 1.0 / p.gb_rho - t / p.gb_radii
    clamped = inv_B_raw < 1e-3
    B = 1.0 / torch.clamp(inv_B_raw, min=1e-3)
    gprime = p.gb_alpha - 2.0 * p.gb_beta * psi + 3.0 * p.gb_gamma * psi**2
    dB_dpsi = B * B * (1.0 - t * t) * gprime / p.gb_radii
    dB_dpsi = torch.where(clamped, torch.zeros_like(dB_dpsi), dB_dpsi)
    return B, dB_dpsi, dIdr


def _gb_energy_pair_coef(p: DenseParams, r, inv_r, one):
    """GB energy + ordered pair-coefficient matrix (incl. Born chain)."""
    B, dB_dpsi, dIdr = born_radii_and_chain(p, r, inv_r, one)
    Bi = B[..., :, None]
    Bj = B[..., None, :]
    BB = Bi * Bj
    r2 = r * r
    expu = torch.exp(-r2 / (4.0 * BB))
    f = torch.sqrt(r2 + BB * expu)
    inv_f = 1.0 / f
    e_cross = (p.qq_full * inv_f * one).sum((-2, -1))
    e_self = (p.gb_pref * p.q * p.q / B).sum(-1)
    e_sa = (p.sa_coef / B**6).sum(-1)
    energy = e_cross + e_self + e_sa

    # dE/dr at fixed B: dE/df * df/dr, df/dr = r (1 - expu/4) / f
    dEdf = -p.qq_full * inv_f * inv_f * one
    G_direct = dEdf * (r * (1.0 - 0.25 * expu) * inv_f)
    # dE/dB_i: cross pairs (B_i sits in row and column), self, SA
    dfdBi = expu * (Bj + r2 / (4.0 * Bi)) * (0.5 * inv_f)
    dEdB = (
        2.0 * (dEdf * dfdBi).sum(-1)
        - p.gb_pref * p.q * p.q / (B * B)
        - 6.0 * p.sa_coef / B**7
    )
    # chain: dE/dr_ij += dEdB_i * dB_i/dpsi_i * rho_i * dI_i/dr_ij
    chain = (dEdB * dB_dpsi * p.gb_rho)[..., None] * dIdr
    return energy, G_direct + chain


def energy_and_forces(p: DenseParams, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total potential energy ``(...)`` and forces ``(..., N, 3)`` for
    positions ``(..., N, 3)``."""
    n = x.shape[-2]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    one = 1.0 - eye
    diff = x[..., :, None, :] - x[..., None, :, :]
    r = torch.sqrt((diff * diff).sum(-1) + _EPS) + eye
    inv_r = 1.0 / r

    forces = torch.zeros_like(x)
    energy = (
        _bond_energy_forces(p, x, forces)
        + _angle_energy_forces(p, x, forces)
        + _torsion_energy_forces(p, x, forces)
    )
    e_nb, G = _nonbonded_energy_pair_coef(p, inv_r)
    energy = energy + e_nb
    if p.use_gb:
        e_gb, G_gb = _gb_energy_pair_coef(p, r, inv_r, one)
        energy = energy + e_gb
        G = G + G_gb
    # pairwise assembly: F_i = -sum_j (G_ij + G_ji) (x_i - x_j) / r_ij
    coef = (G + G.transpose(-1, -2)) * inv_r * one
    forces = forces - (coef[..., None] * diff).sum(-2)
    return energy, forces


__all__ = [
    "DenseParams", "make_dense_params", "energy_and_forces",
    "born_radii_and_chain",
]
