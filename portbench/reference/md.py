"""The plain reference: GBn2 implicit-solvent energy with forces by
autograd, the DeepTICA harmonic-expansion CV bias, folded BAOAB Langevin
steps on the Philox4x32-10 noise stream, and the parity-alternating
neighbour Metropolis exchange.

Plain PyTorch in any floating type (float64 judges; a lower type is the
control), written from the published equations: Onufriev-Bashford-Case
(OBC2) and GBn2 Born radii (HCT integral; under GBn2 the Mongan neck, its
d0 / m0 from ``neck.py``, and per-element tanh rescaling), Still's f_GB, the ACE surface term, amber bonded terms and
1-4 scaling; OpenMM's LangevinMiddleIntegrator; Salmon et al.'s Philox
(SC'11) keyed as the noise stream of the REMD configuration states:
key (replica seed, rung), counter (step low word, step high word, atom,
0), three normals by Box-Muller from the top 24 bits of the four words;
the exchange's uniform of pair p at attempt a from key (seed, 0x53574150)
and counter (a low word, a high word, p, 1). Nothing here imports the
measured package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .neck import lookup_neck
from .params import (COULOMB, PROBE_RADIUS, SOLUTE_DIELECTRIC, SOLVENT_DIELECTRIC,
                     SURFACE_TENSION)

BOLTZMANN = 0.00831446261815324      # kJ/mol/K
SWAP_KEY = 0x53574150
_M32 = 0xFFFFFFFF
_EPS = 1e-12


# --- Philox4x32-10 on int64 tensors holding 32-bit words -------------------------

def _mulhilo(a: int, b: torch.Tensor):
    lo_a, hi_a = a & 0xFFFF, a >> 16
    x = b * lo_a
    y = b * hi_a
    lo = (x + ((y & 0xFFFF) << 16)) & _M32
    hi = (y + (x >> 16)) >> 16
    return hi, lo


def philox(c0, c1, c2, c3, k0, k1):
    for rnd in range(10):
        if rnd:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _u24(w: torch.Tensor, dtype) -> torch.Tensor:
    return ((w >> 8).to(dtype) + 0.5) / 16777216.0


def step_noise(seeds: torch.Tensor, step: int, n_atoms: int, dtype,
               n_steps: int = 1) -> torch.Tensor:
    """Standard normals (n_steps, R, N, 3) of global steps ``step``,
    ``step + 1``, ..."""
    dev = seeds.device
    R = seeds.shape[0]
    shape = (n_steps, R, n_atoms)
    k0 = (seeds.to(torch.int64) & _M32)[None, :, None].expand(shape)
    k1 = torch.arange(R, device=dev, dtype=torch.int64)[None, :, None].expand(shape)
    c2 = torch.arange(n_atoms, device=dev, dtype=torch.int64)[None, None, :].expand(shape)
    steps = step + torch.arange(n_steps, device=dev, dtype=torch.int64)[:, None, None]
    c0 = (steps & _M32).expand(shape)
    c1 = ((steps >> 32) & _M32).expand(shape)
    w0, w1, w2, w3 = philox(c0, c1, c2, torch.zeros_like(c2), k0, k1)
    ra = torch.sqrt(-2.0 * torch.log(_u24(w0, dtype)))
    rb = torch.sqrt(-2.0 * torch.log(_u24(w2, dtype)))
    ta = 2.0 * math.pi * _u24(w1, dtype)
    tb = 2.0 * math.pi * _u24(w3, dtype)
    return torch.stack([ra * torch.cos(ta), ra * torch.sin(ta), rb * torch.cos(tb)], -1)


def swap_uniforms(seed: int, attempts: np.ndarray, n_replicas: int) -> np.ndarray:
    """Uniforms (A, R) of the exchange attempts ``attempts`` (global
    indices): entry [a, p] decides the pair (p, p + 1)."""
    a = torch.as_tensor(np.asarray(attempts, np.int64))[:, None]
    p = torch.arange(n_replicas, dtype=torch.int64)[None, :]
    shape = (a.shape[0], n_replicas)
    full = lambda v: torch.full(shape, int(v), dtype=torch.int64)  # noqa: E731
    w0, _, _, _ = philox((a & _M32).expand(shape), ((a >> 32) & _M32).expand(shape),
                         p.expand(shape), full(1), full(int(seed) & 0x7FFFFFFF),
                         full(SWAP_KEY))
    return _u24(w0, torch.float64).numpy()


def ladder(t_min: float, t_max: float, n: int) -> np.ndarray:
    """The geometric temperature ladder (K)."""
    return t_min * (t_max / t_min) ** (np.arange(n) / (n - 1))


# --- energy -------------------------------------------------------------------------

class DeepTICABias:
    """``E = strength * sum(cv^2)``, cv = whiten(MLP(standardise(cos phi,
    sin phi))) over the (M, 4) dihedrals ``quads``; a tanh MLP."""

    def __init__(self, weights: Dict[str, np.ndarray], quads, strength: float,
                 dtype, device):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)  # noqa: E731
        self.quads = torch.as_tensor(np.asarray(quads, np.int64), device=device)
        self.mu = t(weights["scaler_mean"])
        self.inv_sigma = 1.0 / t(weights["scaler_scale"])
        self.layers = [(t(w), t(b)) for w, b in zip(weights["w"], weights["b"])]
        self.wmean = t(weights["whiten_mean"])
        self.wmat = t(weights["whiten_transform"])
        self.strength = float(strength)

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quads
        p0, p1, p2, p3 = (x[..., q[:, k], :] for k in range(4))
        b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
        n1, n2 = torch.cross(b0, b1, dim=-1), torch.cross(b1, b2, dim=-1)
        b1n = b1 / torch.sqrt((b1 * b1).sum(-1, keepdim=True))
        phi = torch.atan2((torch.cross(n1, n2, dim=-1) * b1n).sum(-1), (n1 * n2).sum(-1))
        h = (torch.cat([torch.cos(phi), torch.sin(phi)], -1) - self.mu) * self.inv_sigma
        for w, b in self.layers[:-1]:
            h = torch.tanh(h @ w + b)
        w, b = self.layers[-1]
        y = ((h @ w + b) - self.wmean) @ self.wmat
        return self.strength * (y * y).sum(-1)


class Reference:
    """GBn2 energy and autograd forces of one system in ``dtype``."""

    def __init__(self, params: Dict[str, np.ndarray], *, dtype=torch.float64,
                 device="cpu", bias: Optional[DeepTICABias] = None):
        self.dtype, self.device = dtype, torch.device(device)
        t = lambda k: torch.as_tensor(np.asarray(params[k], np.float64), dtype=dtype, device=self.device)  # noqa: E731
        i = lambda k: torch.as_tensor(np.asarray(params[k], np.int64), device=self.device)  # noqa: E731
        self.n = int(len(params["masses"]))
        self.masses = torch.as_tensor(params["masses"], dtype=torch.float64, device=self.device)
        self.q = t("charges")
        self.bond_idx, self.bond_k, self.bond_r0 = i("bond_idx"), t("bond_k"), t("bond_r0")
        self.angle_idx, self.angle_k, self.angle_t0 = i("angle_idx"), t("angle_k"), t("angle_t0")
        self.tors_idx, self.tors_k = i("tors_idx"), t("tors_k")
        self.tors_n, self.tors_phase = t("tors_n"), t("tors_phase")
        sig, eps = params["sigma"], params["eps"]
        self.lj_sig = torch.as_tensor(0.5 * (sig[:, None] + sig[None, :]), dtype=dtype, device=self.device)
        self.lj_eps = torch.as_tensor(np.sqrt(eps[:, None] * eps[None, :]), dtype=dtype, device=self.device)
        self.scale_e, self.scale_l = t("scale_e"), t("scale_l")
        self.radii = t("gb_radii")
        self.rho = self.radii - float(params["gb_offset"])
        self.sr = t("gb_screen") * self.rho
        self.alpha, self.beta, self.gamma = t("gb_alpha"), t("gb_beta"), t("gb_gamma")
        self.neck_scale = float(params["gb_neck_scale"])
        if self.neck_scale:
            d0, m0 = lookup_neck(np.asarray(params["gb_radii"]) - float(params["gb_offset"]))
            as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)  # noqa: E731
            self.d0, self.m0 = as_t(d0), as_t(m0)
        self.off = 1.0 - torch.eye(self.n, dtype=dtype, device=self.device)
        self.upper = torch.triu(torch.ones(self.n, self.n, dtype=dtype, device=self.device), 1)
        self.bias = bias

    def _dist(self, x):
        """Pair distances with 1 on the diagonal, so that no term of an atom
        with itself, masked or not, is large or infinite in any type."""
        d = x[..., :, None, :] - x[..., None, :, :]
        r = torch.sqrt((d * d).sum(-1) + _EPS)
        return torch.where(self.off > 0, r, torch.ones_like(r))

    def _bonded(self, x):
        g = lambda idx: x[..., idx, :]  # noqa: E731
        b = self.bond_idx
        r = torch.sqrt(((g(b[:, 0]) - g(b[:, 1])) ** 2).sum(-1))
        e = (0.5 * self.bond_k * (r - self.bond_r0) ** 2).sum(-1)
        a = self.angle_idx
        v1, v2 = g(a[:, 0]) - g(a[:, 1]), g(a[:, 2]) - g(a[:, 1])
        theta = torch.atan2(torch.linalg.vector_norm(torch.cross(v1, v2, dim=-1), dim=-1),
                            (v1 * v2).sum(-1))
        e = e + (0.5 * self.angle_k * (theta - self.angle_t0) ** 2).sum(-1)
        q = self.tors_idx
        b0, b1, b2 = g(q[:, 1]) - g(q[:, 0]), g(q[:, 2]) - g(q[:, 1]), g(q[:, 3]) - g(q[:, 2])
        n1, n2 = torch.cross(b0, b1, dim=-1), torch.cross(b1, b2, dim=-1)
        b1n = b1 / torch.sqrt((b1 * b1).sum(-1, keepdim=True))
        phi = torch.atan2((torch.cross(n1, n2, dim=-1) * b1n).sum(-1), (n1 * n2).sum(-1))
        return e + (self.tors_k * (1.0 + torch.cos(self.tors_n * phi - self.tors_phase))).sum(-1)

    def _gb_born(self, r):
        """Born radii (..., N): HCT integral of every partner j over atom i,
        the neck under GBn2 (atom i's integral against partner j: entry
        [i, j] of d0 / m0), the tanh rescale (1/B at least 1e-3 / nm)."""
        rho_i = self.rho[:, None]
        sr_j = self.sr[None, :]
        U_raw = r + sr_j
        active = (U_raw > rho_i).to(r.dtype) * self.off
        U = torch.where(U_raw > rho_i, U_raw, rho_i + 1.0)
        L = torch.maximum(torch.abs(r - sr_j), rho_i.expand_as(r))
        term = (1.0 / L - 1.0 / U + 0.25 * (r - sr_j * sr_j / r) * (1.0 / U ** 2 - 1.0 / L ** 2)
                + 0.5 * torch.log(L / U) / r)
        term = term + torch.where(sr_j - r > rho_i, 2.0 * (1.0 / rho_i - 1.0 / L),
                                  torch.zeros_like(term))
        I = 0.5 * (term * active).sum(-1)
        if self.neck_scale:
            u = r - self.d0
            neck = self.m0 / (1.0 + 100.0 * u * u + 0.3e6 * u ** 6)
            I = I + self.neck_scale * (neck * self.off).sum(-1)
        psi = I * self.rho
        arg = self.alpha * psi - self.beta * psi * psi + self.gamma * psi ** 3
        inv_b = 1.0 / self.rho - torch.tanh(arg) / self.radii
        return 1.0 / torch.clamp(inv_b, min=1e-3)

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """Potential energy (kJ/mol) of positions (..., N, 3), bias included."""
        x = x.to(self.dtype)
        r = self._dist(x)
        inv_r = 1.0 / r
        sr6 = (self.lj_sig * inv_r) ** 6
        e_lj = 4.0 * self.lj_eps * (sr6 * sr6 - sr6) * self.scale_l
        qq = self.q[:, None] * self.q[None, :]
        e_el = (COULOMB / SOLUTE_DIELECTRIC) * qq * inv_r * self.scale_e
        e = self._bonded(x) + ((e_lj + e_el) * self.upper).sum((-2, -1))
        B = self._gb_born(r)
        BB = B[..., :, None] * B[..., None, :]
        f = torch.sqrt(r * r + BB * torch.exp(-(r * r) / (4.0 * BB)))
        pref = -0.5 * COULOMB * (1.0 / SOLUTE_DIELECTRIC - 1.0 / SOLVENT_DIELECTRIC)
        e = e + pref * (qq * self.off / f).sum((-2, -1)) + pref * (self.q ** 2 / B).sum(-1)
        e = e + SURFACE_TENSION * ((self.radii + PROBE_RADIUS) ** 2 * (self.radii / B) ** 6).sum(-1)
        if self.bias is not None:
            e = e + self.bias.energy(x)
        return e

    def energy_and_forces(self, x: torch.Tensor):
        with torch.enable_grad():
            y = x.detach().to(self.dtype).requires_grad_(True)
            e = self.energy(y)
            (g,) = torch.autograd.grad(e.sum(), y)
        return e.detach(), -g

    def energies(self, frames: np.ndarray, block: int = 256) -> np.ndarray:
        """Energies (F, R) of host frames (F, R, N, 3), in blocks of rows."""
        flat = frames.reshape(-1, self.n, 3)
        out = []
        for s in range(0, flat.shape[0], block):
            xb = torch.as_tensor(flat[s:s + block], device=self.device)
            out.append(self.energy(xb).to(torch.float64).cpu().numpy())
        return np.concatenate(out).reshape(frames.shape[:-2])


# --- dynamics and exchange ------------------------------------------------------------

def baoab_window(ref: Reference, x, v, seeds, temps, step0: int, n_steps: int,
                 dt: float, friction: float, state_dtype=None):
    """``n_steps`` folded BAOAB steps (kick dt f/m, drift dt/2, O, drift
    dt/2) of every replica; returns (x, v) in ``state_dtype`` (the
    reference's type by default)."""
    sd = state_dtype or ref.dtype
    inv_m = (1.0 / ref.masses).to(sd)[:, None]
    c1 = math.exp(-friction * dt)
    kT = (BOLTZMANN * torch.as_tensor(temps, dtype=torch.float64, device=ref.device)).to(sd)
    c2 = torch.sqrt((1.0 - c1 * c1) * kT[:, None, None] * inv_m)
    x, v = x.to(sd), v.to(sd)
    noise = step_noise(seeds, step0, ref.n, sd, n_steps)
    for k in range(n_steps):
        _, f = ref.energy_and_forces(x)
        v = v + dt * f.to(sd) * inv_m
        x = x + 0.5 * dt * v
        v = c1 * v + c2 * noise[k]
        x = x + 0.5 * dt * v
    return x, v


def swap_decisions(energies: np.ndarray, temps: np.ndarray, u: np.ndarray, parity: int):
    """Left rungs of the pairs attempted at ``parity``, the accept of each
    and its margin |log u - log acc| (float64). ``energies`` and ``u`` are
    (R,) or (A, R) for A attempts of that parity."""
    R = len(temps)
    betas = 1.0 / (BOLTZMANN * np.asarray(temps, np.float64))
    left = np.arange(parity % 2, R - 1, 2)
    e = np.asarray(energies, np.float64)
    log_acc = (betas[left] - betas[left + 1]) * (e[..., left] - e[..., left + 1])
    log_u = np.log(np.asarray(u)[..., left] + 1e-30)
    return left, log_u < log_acc, np.abs(log_u - log_acc)


def swap_target(R: int, left: Sequence[int], accepted: np.ndarray) -> np.ndarray:
    """Where each rung takes its configuration from after the exchange."""
    target = np.arange(R)
    for p, acc in zip(left, accepted):
        if acc:
            target[p], target[p + 1] = p + 1, p
    return target


__all__ = ["Reference", "DeepTICABias", "baoab_window", "swap_decisions", "swap_target",
           "swap_uniforms", "step_noise", "ladder", "philox", "BOLTZMANN"]
