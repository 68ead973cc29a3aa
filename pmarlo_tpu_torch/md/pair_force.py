"""Protein-scale implicit-solvent forces: three GB pair sweeps as CUDA
kernels, each with its plain PyTorch twin.

Port of ``pmarlo_tpu/md/pallas_pair.py build_pair_force_fn``, the dense
path (``gb_cutoff=None``, ``newton=False``, ``bonded="gather"``): the same
NoCutoff LJ + Coulomb + GB (OBC2 or GBn2 with neck) + ACE surface term,
with nothing of size (N, N) stored anywhere. A force evaluation is

1. ``born``: the Born integral I_i (HCT + GBn2 neck), one pass over pairs;
2. glue: tanh rescale to Born radii B, with dB/dpsi (zero where 1/B is
   clamped at 1e-3, so the force stays the gradient of the energy);
3. ``energy_rows``: per-row LJ + Coulomb (index-band masked) + GB cross
   energy, and the pairwise part of dE/dB_i;
4. glue: self and SA terms, chain coefficients c = dE/dB dB/dpsi rho;
5. ``pair_forces``: F_i = -sum_j W_ij (x_i - x_j) / r;
6. the band add-back of the masked exclusions at their wanted scale
   (``md/cells.py``), and the bonded terms (index gathers, no (N, N)).

Sweeps 1, 3 and 5 are ``csrc/pair_force.cu`` on CUDA tensors and their
twins (``*_reference``, row-chunked so memory stays O(tile * N)) on CPU
tensors: a CUDA tensor launches the kernel or raises. Steps 2, 4 and 6 are
plain PyTorch on either device. ``launches`` counts kernel launches by
kernel name.

Pair arithmetic is float32, but the energy is summed in float64 (the
energy rows, the self/SA, correction and bonded sums) and the Born sums
too: near a minimum a protein's total energy is ~1% of its components, so
float32 totals would keep only three or four digits. The energy twin
evaluates its pair terms in float64 outright (see
``energy_rows_reference``). The energy comes back as float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..constants import COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
from .analytic import bonded_energy_and_forces, make_bonded_params
from .cells import ExclusionBand
from .ff_params import OBC2_ALPHA, OBC2_BETA, OBC2_GAMMA
from .system import System, require_no_vsites

_EPS = 1e-12

#: kernel launches made by this process, by kernel (chip_smoke.py resets
#: and reads them); one force evaluation on the card launches each once
launches = {"pair_born": 0, "pair_energy": 0, "pair_force": 0}

_configured = False


def _library() -> ctypes.CDLL:
    global _configured
    lib = _kernels.library()
    if not _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pmarlo_pair_born.argtypes = [p, p, p, p, p, i, i, i, i, p, p]
        lib.pmarlo_pair_energy.argtypes = [p, p, p, i, i, i, f, f, i, p, p, p]
        lib.pmarlo_pair_force.argtypes = (
            [p, p, p, p, p, i, p, p, i, i, i, f, f, i, i, p, p]
        )
        for fn in (lib.pmarlo_pair_born, lib.pmarlo_pair_energy,
                   lib.pmarlo_pair_force):
            fn.restype = i
        lib.pmarlo_pair_max_classes.argtypes = []
        lib.pmarlo_pair_max_classes.restype = i
        if lib.pmarlo_pair_max_classes() != MAX_CLASSES:
            raise RuntimeError("kernel library and wrapper disagree on MAX_CLASSES")
        _configured = True
    return lib


#: radius classes the kernels hold in shared memory (csrc/pair_force.cu)
MAX_CLASSES = 64


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
    leading shape (``()`` or ``(R,)``). Built by ``build_pair_force_fn``."""

    def __init__(self, system: System, *, tile: int = 128,
                 band: Optional[ExclusionBand] = None,
                 dtype: torch.dtype = torch.float32):
        require_no_vsites(system, "the pair force path")
        if system.box is not None:
            raise NotImplementedError("periodic systems: ROADMAP queue A12")
        if int(tile) < 1:
            raise ValueError(f"tile must be positive, got {tile}")
        self.system = system
        self.tile = int(tile)
        self.dtype = dtype
        n = system.n_atoms
        dev = system.device

        def host(t):
            return t.detach().cpu().double().numpy()

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        q = host(system.charges)
        radii = host(system.gb_radii)
        rho = radii - system.gb_offset
        sr = host(system.gb_screen) * rho
        self.use_gb = bool(system.use_gb)
        self.ke = COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 / system.solute_dielectric
        self.gb_pref = (
            -0.5 * COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
            * (1.0 / system.solute_dielectric - 1.0 / system.solvent_dielectric)
        )
        probe = 0.14
        if system.gb_alpha is not None:
            ab, bb, gb = (host(system.gb_alpha), host(system.gb_beta),
                          host(system.gb_gamma))
        else:
            ab = np.full(n, OBC2_ALPHA)
            bb = np.full(n, OBC2_BETA)
            gb = np.full(n, OBC2_GAMMA)
        self.q, self.rho, self.radii = f32(q), f32(rho), f32(radii)
        self.sr = f32(sr)
        self.sig = f32(host(system.lj_sigma))
        # sqrt(eps) per atom: the Lorentz-Berthelot mean is a product
        self.seps = f32(np.sqrt(np.maximum(host(system.lj_eps), 0.0)))
        self.sa = f32(system.surface_tension * (radii + probe) ** 2 * radii**6)
        self.ab, self.bb, self.gb = f32(ab), f32(bb), f32(gb)
        # the kernels' float32 copies of the per-atom rows and class tables
        self._atom_p = torch.stack(
            [self.q, self.sig, self.seps, self.rho, self.sr]
        ).float().contiguous()

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
        self._cls = torch.as_tensor(cls, dtype=torch.int32, device=dev)
        self._cls_long = self._cls.long()
        self._d0c = f32(d0c)
        self._m0c = f32(m0c)
        self._d0c_k = self._d0c.float().contiguous()
        self._m0c_k = self._m0c.float().contiguous()

        self.band = band if band is not None else ExclusionBand.from_system(system)
        if self.band.band_se.shape[0] != n:
            raise ValueError("exclusion band built for another system")
        self.band_D = int(self.band.width)
        pi, pj, c_el, c_lj = self.band.correction_pairs()
        eps_all = host(system.lj_eps)
        sig_all = host(system.lj_sigma)
        self._corr_i = torch.as_tensor(pi, dtype=torch.long, device=dev)
        self._corr_j = torch.as_tensor(pj, dtype=torch.long, device=dev)
        self._corr_sig = f32(0.5 * (sig_all[pi] + sig_all[pj]))
        self._corr_lj = f32(4.0 * c_lj * np.sqrt(np.maximum(
            eps_all[pi] * eps_all[pj], 0.0)))
        self._corr_el = f32(self.ke * c_el * q[pi] * q[pj])
        self._bonded = make_bonded_params(system, dtype=dtype)

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

    # --- plain PyTorch twins of the three kernels -------------------------------

    def _chunks(self, x):
        """Row chunks ``(s, e, d, r, one)``: separations ``(R, c, N, 3)``
        of rows s:e against all atoms, distances with self and coincident
        slots pushed to 1 nm, and the mask of genuine pairs."""
        n = x.shape[1]
        for s in range(0, n, self.tile):
            e = min(s + self.tile, n)
            d = x[:, s:e, None, :] - x[:, None, :, :]
            r2 = (d * d).sum(-1)
            pair = r2 > 1e-8
            r = torch.where(pair, torch.sqrt(r2 + _EPS), torch.ones_like(r2))
            yield s, e, d, r, pair.to(x.dtype)

    def _neck_tables(self, s, e):
        ci = self._cls_long[s:e, None]
        cj = self._cls_long[None, :]
        return self._d0c[ci, cj], self._m0c[ci, cj]

    def born_reference(self, x: torch.Tensor) -> torch.Tensor:
        """Born integral ``I (R, N)`` (twin of ``pair_born_kernel``)."""
        x = self._batch(x)
        out = torch.empty(x.shape[:2], dtype=x.dtype, device=x.device)
        for s, e, _, r, one in self._chunks(x):
            inv_r = 1.0 / r
            H, _ = _hct(r, inv_r, self.rho[s:e, None], self.sr[None, :],
                        derivative=False)
            I = 0.5 * (H * one).sum(-1, dtype=torch.float64)
            if self.use_neck:
                d0, m0 = self._neck_tables(s, e)
                nv, _ = _neck(r, d0, m0)
                I = I + (nv * one).sum(-1, dtype=torch.float64)
            out[:, s:e] = I.to(x.dtype)
        return out

    def _band_mask(self, s, e, n, dev):
        ii = torch.arange(s, e, device=dev)[:, None]
        jj = torch.arange(n, device=dev)[None, :]
        return ((ii - jj).abs() > self.band_D).to(self.dtype)

    def energy_rows_reference(self, x: torch.Tensor, B: torch.Tensor):
        """``(e_rows (R, N) float64, dEdB_pair (R, N))`` (twin of
        ``pair_energy_kernel``). The pair terms are evaluated in float64:
        as the reference the kernel's energies are held to, the twin must
        not carry float32's correlated rounding (a few dozen distinct
        charge products repeat over millions of pairs, so their rounding
        errors add up instead of averaging out)."""
        x = self._batch(x)
        n = x.shape[1]
        f64 = torch.float64
        q, sig, seps = self.q.to(f64), self.sig.to(f64), self.seps.to(f64)
        B = B.to(f64)
        e_out = torch.empty(x.shape[:2], dtype=f64, device=x.device)
        b_out = torch.zeros(x.shape[:2], dtype=f64, device=x.device)
        for s, e, _, r, one in self._chunks(x.to(f64)):
            inv_r = 1.0 / r
            ob = self._band_mask(s, e, n, x.device).to(f64)
            sr6 = _sr6(0.5 * (sig[s:e, None] + sig[None, :]), inv_r)
            eps = seps[s:e, None] * seps[None, :]
            qq = q[s:e, None] * q[None, :]
            e_nb = (4.0 * eps * (sr6 * sr6 - sr6) + self.ke * qq * inv_r) * ob
            e_row = 0.5 * (e_nb * one).sum(-1)
            if self.use_gb:
                Bi = B[:, s:e, None]
                Bj = B[:, None, :]
                BB = Bi * Bj
                rsq = r * r
                expu = torch.exp(-rsq / (4.0 * BB))
                inv_f = 1.0 / torch.sqrt(rsq + BB * expu)
                qq_gb = self.gb_pref * qq
                e_row = e_row + (qq_gb * inv_f * one).sum(-1)
                dEdf = -qq_gb * inv_f * inv_f * one
                dfdBi = expu * (Bj + rsq / (4.0 * Bi)) * (0.5 * inv_f)
                b_out[:, s:e] = (dEdf * dfdBi).sum(-1)
            e_out[:, s:e] = e_row
        return e_out, b_out.to(x.dtype)

    def pair_forces_reference(self, x: torch.Tensor, B: torch.Tensor,
                              c: torch.Tensor) -> torch.Tensor:
        """Pair forces ``(R, N, 3)`` (twin of ``pair_force_kernel``)."""
        x = self._batch(x)
        n = x.shape[1]
        out = torch.empty_like(x)
        for s, e, d, r, one in self._chunks(x):
            inv_r = 1.0 / r
            ob = self._band_mask(s, e, n, x.device)
            sr6 = _sr6(0.5 * (self.sig[s:e, None] + self.sig[None, :]), inv_r)
            eps = self.seps[s:e, None] * self.seps[None, :]
            qq = self.q[s:e, None] * self.q[None, :]
            W = (4.0 * eps * (-12.0 * sr6 * sr6 + 6.0 * sr6) * inv_r
                 - self.ke * qq * inv_r * inv_r) * ob
            if self.use_gb:
                Bi = B[:, s:e, None]
                Bj = B[:, None, :]
                BB = Bi * Bj
                rsq = r * r
                expu = torch.exp(-rsq / (4.0 * BB))
                inv_f = 1.0 / torch.sqrt(rsq + BB * expu)
                dEdf = -(self.gb_pref * 2.0 * qq) * inv_f * inv_f
                W = W + dEdf * (r * (1.0 - 0.25 * expu) * inv_f)
                _, dH_ij = _hct(r, inv_r, self.rho[s:e, None], self.sr[None, :],
                                value=False)
                _, dH_ji = _hct(r, inv_r, self.rho[None, :], self.sr[s:e, None],
                                value=False)
                dI_ij = 0.5 * dH_ij
                dI_ji = 0.5 * dH_ji
                if self.use_neck:
                    d0, m0 = self._neck_tables(s, e)
                    _, dnv = _neck(r, d0, m0)
                    dI_ij = dI_ij + dnv
                    dI_ji = dI_ji + dnv
                W = W + c[:, s:e, None] * dI_ij + c[:, None, :] * dI_ji
            W = W * one * inv_r
            out[:, s:e] = -(W[..., None] * d).sum(-2)
        return out

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

    def _launch_born(self, x):
        self._check_cuda("pair_born", x)
        lib = _library()
        R, n = x.shape[0], x.shape[1]
        out = torch.empty((R, n), dtype=torch.float32, device=x.device)
        rc = lib.pmarlo_pair_born(
            x.data_ptr(), self._atom_p.data_ptr(), self._cls.data_ptr(),
            self._d0c_k.data_ptr(), self._m0c_k.data_ptr(), self._d0c_k.shape[0],
            R, n, int(self.use_neck), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _kernels.check_launch(rc, "pair_born")
        launches["pair_born"] += 1
        return out

    def _launch_energy(self, x, B):
        self._check_cuda("pair_energy", x, B)
        lib = _library()
        R, n = x.shape[0], x.shape[1]
        e_rows = torch.empty((R, n), dtype=torch.float64, device=x.device)
        dedb = torch.empty((R, n), dtype=torch.float32, device=x.device)
        rc = lib.pmarlo_pair_energy(
            x.data_ptr(), self._atom_p.data_ptr(), B.data_ptr(), R, n,
            self.band_D, self.ke, self.gb_pref, int(self.use_gb),
            e_rows.data_ptr(), dedb.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _kernels.check_launch(rc, "pair_energy")
        launches["pair_energy"] += 1
        return e_rows, dedb

    def _launch_force(self, x, B, c):
        self._check_cuda("pair_force", x, B, c)
        lib = _library()
        R, n = x.shape[0], x.shape[1]
        out = torch.empty_like(x)
        rc = lib.pmarlo_pair_force(
            x.data_ptr(), self._atom_p.data_ptr(), self._cls.data_ptr(),
            self._d0c_k.data_ptr(), self._m0c_k.data_ptr(), self._d0c_k.shape[0],
            B.data_ptr(), c.data_ptr(), R, n, self.band_D, self.ke,
            self.gb_pref, int(self.use_gb), int(self.use_neck), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _kernels.check_launch(rc, "pair_force")
        launches["pair_force"] += 1
        return out

    # --- per-sweep entry points: the twin on the CPU, the kernel on CUDA ----------

    def born(self, x: torch.Tensor) -> torch.Tensor:
        x = self._batch(x)
        if x.device.type == "cpu":
            return self.born_reference(x)
        return self._launch_born(x.contiguous())

    def energy_rows(self, x: torch.Tensor, B: torch.Tensor):
        x = self._batch(x)
        if x.device.type == "cpu":
            return self.energy_rows_reference(x, B)
        return self._launch_energy(x.contiguous(), B.contiguous())

    def pair_forces(self, x: torch.Tensor, B: torch.Tensor, c: torch.Tensor):
        x = self._batch(x)
        if x.device.type == "cpu":
            return self.pair_forces_reference(x, B, c)
        return self._launch_force(x.contiguous(), B.contiguous(), c.contiguous())

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
        """Band add-back and far-pair correction: energies ``(R,)`` and
        forces ``(R, N, 3)``."""
        x = self._batch(x)
        forces = torch.zeros_like(x)
        if self._corr_i.numel() == 0:
            return x.new_zeros(x.shape[0], dtype=torch.float64), forces
        d = x[:, self._corr_i] - x[:, self._corr_j]
        r = torch.sqrt((d * d).sum(-1) + _EPS)
        inv_r = 1.0 / r
        sr6 = _sr6(self._corr_sig, inv_r)
        el = self._corr_el * inv_r
        energy = (self._corr_lj * (sr6 * sr6 - sr6) + el).sum(-1, dtype=torch.float64)
        dEdr = (self._corr_lj * (-12.0 * sr6 * sr6 + 6.0 * sr6) - el) * inv_r
        f_i = -(dEdr * inv_r)[..., None] * d
        forces.index_add_(1, self._corr_i, f_i)
        forces.index_add_(1, self._corr_j, -f_i)
        return energy, forces

    def _evaluate(self, x, born, energy_rows, pair_forces):
        lead = tuple(x.shape[:-2])
        xb = self._batch(x.reshape((-1,) + tuple(x.shape[-2:])))
        if self.use_gb:
            B, dB = self.born_radii(born(xb))
        else:
            B = torch.ones(xb.shape[:2], dtype=xb.dtype, device=xb.device)
        e_rows, dEdB_pair = energy_rows(xb, B)
        energy = e_rows.sum(-1)
        if self.use_gb:
            e_gb, c = self.gb_terms(B, dB, dEdB_pair)
            energy = energy + e_gb
        else:
            c = torch.zeros_like(B)
        forces = pair_forces(xb, B, c)
        e_c, f_c = self.correction(xb)
        e_b, f_b = bonded_energy_and_forces(self._bonded, xb,
                                            energy_dtype=torch.float64)
        energy = (energy + e_c + e_b).to(xb.dtype)
        forces = forces + f_c + f_b
        return energy.reshape(lead), forces.reshape(tuple(x.shape))

    def __call__(self, x: torch.Tensor):
        """Energy and forces: the kernels on a CUDA tensor, the twins on a
        CPU tensor."""
        return self._evaluate(x, self.born, self.energy_rows, self.pair_forces)

    def reference(self, x: torch.Tensor):
        """The plain twin of the whole evaluation, on any device."""
        return self._evaluate(x, self.born_reference, self.energy_rows_reference,
                              self.pair_forces_reference)

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
    """The dense pair force function of ``system`` (tensors on
    ``system.device``), as ``pallas_pair.build_pair_force_fn`` builds it
    with ``gb_cutoff=None``.

    ``tile`` is the row chunk of the plain twins (their memory is
    O(tile * N) a sweep); the kernels' block shape is fixed in
    ``csrc/pair_force.cu``. ``dtype=torch.float64`` gives a float64 twin
    (a precision reference; the kernels take float32 only). ``band`` overrides the exclusion band built
    from the system (``ExclusionBand.from_numpy`` carries JAX's).

    Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
    row: ``gb_cutoff``, ``order_from`` and ``newton`` (the tile-culled and
    Newton sweeps, queue B rows 6-7) and ``bonded="window"`` (row 10)."""
    if gb_cutoff is not None or order_from is not None:
        raise NotImplementedError(
            "gb_cutoff/order_from: the tile-culled GB sweeps are ROADMAP "
            "queue B rows 6-7"
        )
    if newton:
        raise NotImplementedError(
            "newton: the symmetric block-list sweeps are ROADMAP queue B rows 6-7"
        )
    if bonded == "window":
        raise NotImplementedError(
            "bonded='window': the windowed bonded kernel is ROADMAP queue B row 10"
        )
    if bonded not in ("auto", "gather"):
        raise ValueError(f"bonded must be auto|gather|window, got {bonded!r}")
    return PairForce(system, tile=tile, band=band, dtype=dtype)


__all__ = ["PairForce", "build_pair_force_fn", "launches", "MAX_CLASSES"]
