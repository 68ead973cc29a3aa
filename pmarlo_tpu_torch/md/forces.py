"""Potential energy as plain PyTorch, with forces by autograd.

Port of ``pmarlo_tpu/md/forces.py``: implicit solvent / vacuum (NoCutoff)
and, for a ``System`` with a box, the dense minimum-image LJ +
reaction-field potential. Every function takes positions ``(..., N, 3)``:
leading dimensions (e.g. replicas) batch, and energies come back with
shape ``(...)``. This is the autodiff reference that ``md/analytic.py``,
the fused kernel, the periodic kernel and the cell-list kernel are held to.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
from .ff_params import OBC2_ALPHA, OBC2_BETA, OBC2_GAMMA
from .gbn2 import neck_value_and_derivative
from .system import System, require_dense_scales, require_no_vsites

_EPS = 1e-12


def lj_switch(r: torch.Tensor, r_switch: float, r_cutoff: float):
    """OpenMM LJ switching function: quintic smoothstep S and dS/dr.

    S(x) = 1 - 10 x^3 + 15 x^4 - 6 x^5 with x = (r - r_sw)/(rc - r_sw),
    clipped to [0, 1]: S = 1 below the switch distance, S = 0 at the
    cutoff, with zero first and second derivatives at both ends, so
    multiplying the unshifted LJ energy by S makes energy and force
    continuous at the cutoff. Returns ``(S, dS/dr)``."""
    inv_w = 1.0 / (r_cutoff - r_switch)
    x = torch.clamp((r - r_switch) * inv_w, 0.0, 1.0)
    s = 1.0 + x * x * x * (-10.0 + x * (15.0 - x * 6.0))
    ds = x * x * (-30.0 + x * (60.0 - x * 30.0)) * inv_w
    return s, ds


def _gather(positions: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return positions[..., idx.long(), :]


def bond_energy(system: System, positions: torch.Tensor) -> torch.Tensor:
    ri = _gather(positions, system.bond_idx[:, 0])
    rj = _gather(positions, system.bond_idx[:, 1])
    r = torch.sqrt(((ri - rj) ** 2).sum(-1) + _EPS)
    return (0.5 * system.bond_k * (r - system.bond_r0) ** 2).sum(-1)


def angle_energy(system: System, positions: torch.Tensor) -> torch.Tensor:
    a = _gather(positions, system.angle_idx[:, 0])
    b = _gather(positions, system.angle_idx[:, 1])
    c = _gather(positions, system.angle_idx[:, 2])
    v1 = a - b
    v2 = c - b
    cos_t = (v1 * v2).sum(-1) / torch.sqrt(
        (v1 * v1).sum(-1) * (v2 * v2).sum(-1) + _EPS
    )
    theta = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    return (0.5 * system.angle_k * (theta - system.angle_t0) ** 2).sum(-1)


def dihedral_angles(positions: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Signed dihedral angles (rad, IUPAC sign) for (M, 4) quadruples:
    ``(..., N, 3) -> (..., M)``."""
    p0 = _gather(positions, idx[:, 0])
    p1 = _gather(positions, idx[:, 1])
    p2 = _gather(positions, idx[:, 2])
    p3 = _gather(positions, idx[:, 3])
    b0 = p1 - p0
    b1 = p2 - p1
    b2 = p3 - p2
    n1 = torch.cross(b0, b1, dim=-1)
    n2 = torch.cross(b1, b2, dim=-1)
    b1n = b1 / torch.sqrt((b1 * b1).sum(-1, keepdim=True) + _EPS)
    x = (n1 * n2).sum(-1)
    y = (torch.cross(n1, n2, dim=-1) * b1n).sum(-1)
    return torch.atan2(y, x)


def torsion_energy(system: System, positions: torch.Tensor) -> torch.Tensor:
    phi = dihedral_angles(positions, system.torsion_idx)
    return (
        system.torsion_k
        * (1.0 + torch.cos(system.torsion_n * phi - system.torsion_phase))
    ).sum(-1)


def _pairwise_distances(positions: torch.Tensor) -> torch.Tensor:
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    return torch.sqrt((diff * diff).sum(-1) + _EPS)


def nonbonded_energy(system: System, positions: torch.Tensor) -> torch.Tensor:
    """LJ 12-6 + Coulomb with per-pair scale matrices (dense, upper-tri)."""
    require_dense_scales(system, "nonbonded_energy")
    r = _pairwise_distances(positions)
    n = r.shape[-1]
    eye = torch.eye(n, dtype=positions.dtype, device=positions.device)
    inv_r = 1.0 / (r + eye)
    sigma_ij = 0.5 * (system.lj_sigma[:, None] + system.lj_sigma[None, :])
    eps_ij = torch.sqrt(torch.clamp(
        system.lj_eps[:, None] * system.lj_eps[None, :], min=0.0))
    sr6 = (sigma_ij * inv_r) ** 6
    e_lj = 4.0 * eps_ij * (sr6 * sr6 - sr6) * system.scale_lj
    qq = system.charges[:, None] * system.charges[None, :]
    e_el = (
        COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 / system.solute_dielectric
    ) * qq * inv_r * system.scale_elec
    upper = torch.triu(torch.ones_like(eye), diagonal=1)
    return ((e_lj + e_el) * upper).sum((-2, -1))


def periodic_nonbonded_energy(system: System, positions: torch.Tensor) -> torch.Tensor:
    """Minimum-image LJ + reaction-field Coulomb for periodic systems
    (OpenMM CutoffPeriodic semantics: RF dielectric ``solvent_dielectric``
    beyond the cutoff; LJ potential-shifted to 0 at the cutoff, or switched
    when ``system.switch_distance`` is set). Dense O(N^2); needs every
    perpendicular box width > 2 * cutoff. Exclusion scales apply to both
    terms; 1-4 Coulomb keeps the plain 1/r form (no RF shift, no cutoff),
    as OpenMM treats exceptions. The autograd oracle of
    ``md/periodic_force.py`` and ``md/cell_force.py``."""
    require_dense_scales(system, "periodic_nonbonded_energy")
    if system.box is None:
        raise ValueError("periodic_nonbonded_energy needs system.box")
    dt, dev = positions.dtype, positions.device
    box = torch.as_tensor(system.box, dtype=dt, device=dev)
    rc = system.cutoff
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    if system.tilt is None:
        diff = diff - box * torch.round(diff / box)
    else:
        # rounded fractional minimum image: exact for every r < cutoff
        # because build_system enforces min perp width > 2*cutoff, and
        # pairs beyond the cutoff are masked whichever image is picked
        from .box import box_matrix, min_image_round

        H = box_matrix(system.box, system.tilt)
        diff = min_image_round(
            diff, torch.as_tensor(H, dtype=dt, device=dev),
            torch.as_tensor(np.linalg.inv(H), dtype=dt, device=dev),
        )
    r2 = (diff * diff).sum(-1)
    n = r2.shape[-1]
    eye = torch.eye(n, dtype=dt, device=dev)
    r = torch.sqrt(r2 + _EPS) + eye
    inv_r = 1.0 / r
    within = (r < rc).to(dt) * (1.0 - eye)

    sigma_ij = 0.5 * (system.lj_sigma[:, None] + system.lj_sigma[None, :]).to(dt)
    eps_ij = torch.sqrt(torch.clamp(
        system.lj_eps[:, None] * system.lj_eps[None, :], min=0.0)).to(dt)
    sr6 = (sigma_ij * inv_r) ** 6
    if system.switch_distance is None:
        sr6c = (sigma_ij / rc) ** 6
        e_lj = 4.0 * eps_ij * ((sr6 * sr6 - sr6) - (sr6c * sr6c - sr6c))
    else:
        sw, _ = lj_switch(r, float(system.switch_distance), rc)
        e_lj = 4.0 * eps_ij * (sr6 * sr6 - sr6) * sw
    e_lj = e_lj * system.scale_lj.to(dt) * within

    # reaction field: E = ke q q (1/r + k_rf r^2 - c_rf), r < rc
    eps_rf = system.solvent_dielectric
    k_rf = (eps_rf - 1.0) / ((2.0 * eps_rf + 1.0) * rc**3)
    c_rf = 1.0 / rc + k_rf * rc * rc
    ke = COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 / system.solute_dielectric
    qq = (system.charges[:, None] * system.charges[None, :]).to(dt)
    scale_elec = system.scale_elec.to(dt)
    full = (scale_elec >= 1.0).to(dt)
    e_rf = ke * qq * (inv_r + k_rf * r * r - c_rf) * full * within
    # 1-4 exceptions: scaled plain Coulomb, no RF shift (OpenMM rule)
    e_14 = ke * qq * inv_r * (scale_elec * (1.0 - full)) * (1.0 - eye)

    upper = torch.triu(torch.ones_like(eye), diagonal=1)
    return ((e_lj + e_rf + e_14) * upper).sum((-2, -1))


def born_radii(system: System, positions: torch.Tensor) -> torch.Tensor:
    """OBC/GBn2 Born radii ``(..., N)``: HCT pair integral (+ GBn2 neck)
    then the tanh rescale."""
    r = _pairwise_distances(positions)
    n = r.shape[-1]
    eye = torch.eye(n, dtype=positions.dtype, device=positions.device)
    rho = system.gb_radii - system.gb_offset
    sr = system.gb_screen * rho
    rho_i = rho[:, None]
    sr_j = sr[None, :]

    U_raw = r + sr_j
    # negative (sulfur) screening can make U <= rho_i: such pairs are
    # masked, and U is sanitized so log() stays finite under the mask
    inactive = U_raw <= rho_i
    U = torch.where(inactive, rho_i + 1.0, U_raw)
    L = torch.maximum(torch.abs(r - sr_j), rho_i.expand_as(r))
    inv_L = 1.0 / L
    inv_U = 1.0 / U
    term = (
        inv_L
        - inv_U
        + 0.25 * (r - sr_j * sr_j / r) * (inv_U * inv_U - inv_L * inv_L)
        + 0.5 * torch.log(L * inv_U) / r
    )
    corr = 2.0 * (1.0 / rho_i - inv_L)
    term = term + torch.where(sr_j - r > rho_i, corr, torch.zeros_like(corr))
    mask = (1.0 - eye) * (~inactive).to(positions.dtype)
    I = 0.5 * (term * mask).sum(-1)

    if system.gb_neck_scale != 0.0 and system.gb_neck_m0 is not None:
        nv, _ = neck_value_and_derivative(r, system.gb_neck_d0, system.gb_neck_m0)
        I = I + system.gb_neck_scale * (nv * (1.0 - eye)).sum(-1)

    psi = I * rho
    psi2 = psi * psi
    if system.gb_alpha is not None:
        tanh_arg = (
            system.gb_alpha * psi - system.gb_beta * psi2
            + system.gb_gamma * psi2 * psi
        )
    else:
        tanh_arg = OBC2_ALPHA * psi - OBC2_BETA * psi2 + OBC2_GAMMA * psi2 * psi
    inv_B = 1.0 / rho - torch.tanh(tanh_arg) / system.gb_radii
    return 1.0 / torch.clamp(inv_B, min=1e-3)


def gb_energy(system: System, positions: torch.Tensor) -> torch.Tensor:
    """Generalized-Born polarization energy + ACE surface-area term."""
    B = born_radii(system, positions)
    r = _pairwise_distances(positions)
    n = r.shape[-1]
    BB = B[..., :, None] * B[..., None, :]
    f = torch.sqrt(r * r + BB * torch.exp(-(r * r) / (4.0 * BB)))
    qq = system.charges[:, None] * system.charges[None, :]
    pref = (
        -0.5 * COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
        * (1.0 / system.solute_dielectric - 1.0 / system.solvent_dielectric)
    )
    off_diag = 1.0 - torch.eye(n, dtype=positions.dtype, device=positions.device)
    e_cross = pref * (qq * off_diag / f).sum((-2, -1))
    e_self = pref * (system.charges ** 2 / B).sum(-1)
    probe = 0.14
    e_sa = system.surface_tension * (
        (system.gb_radii + probe) ** 2 * (system.gb_radii / B) ** 6
    ).sum(-1)
    return e_cross + e_self + e_sa


def potential_energy(system: System, positions: torch.Tensor,
                     bias_fn: Optional[Callable] = None) -> torch.Tensor:
    """Total potential energy (kJ/mol), shape ``(...)``; a bias
    ``bias_fn(positions (..., N, 3)) -> energy (...)`` is added when given
    (its forces then come with the others from autograd)."""
    require_no_vsites(system, "potential_energy")
    e = sum(energy_components(system, positions).values())
    if bias_fn is not None:
        e = e + bias_fn(positions)
    return e


def energy_components(system: System, positions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The terms of ``potential_energy`` by name: ``bond``, ``angle``,
    ``torsion``, ``nonbonded`` (periodic when the system has a box) and,
    in implicit solvent, ``gb``."""
    nb = periodic_nonbonded_energy if system.box is not None else nonbonded_energy
    comps = {
        "bond": bond_energy(system, positions),
        "angle": angle_energy(system, positions),
        "torsion": torsion_energy(system, positions),
        "nonbonded": nb(system, positions),
    }
    if system.use_gb:
        comps["gb"] = gb_energy(system, positions)
    return comps


def energy_and_forces_autograd(system: System, positions: torch.Tensor,
                               bias_fn: Optional[Callable] = None):
    """``(energy (...), forces (..., N, 3))`` with forces = -dE/dx by
    autograd (detached outputs), the bias included when given."""
    with torch.enable_grad():
        x = positions.detach().requires_grad_(True)
        e = potential_energy(system, x, bias_fn)
        (g,) = torch.autograd.grad(e.sum(), x)
    return e.detach(), -g


def compute_forces(system: System, positions: torch.Tensor,
                   bias_fn: Optional[Callable] = None) -> torch.Tensor:
    """Forces (kJ/mol/nm) = -dE/dx, the bias included when given."""
    return energy_and_forces_autograd(system, positions, bias_fn)[1]


__all__ = [
    "potential_energy", "energy_components", "compute_forces",
    "energy_and_forces_autograd", "bond_energy", "angle_energy",
    "torsion_energy", "nonbonded_energy", "periodic_nonbonded_energy",
    "lj_switch", "gb_energy", "born_radii", "dihedral_angles",
]
