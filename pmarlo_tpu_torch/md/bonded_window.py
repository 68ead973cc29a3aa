"""Bonded terms of large systems as one CUDA kernel: bond, angle and
periodic-torsion energies with their analytic gradient.

Port of ``pmarlo_tpu/md/bonded_window.py build_bonded_window``: the same
contract, ``fn(x) -> (energy, grad)`` with ``grad = dE/dx`` (callers negate
for forces), and ``None`` for a system without bonded terms. What the TPU
kernel needed and this card does not is gone: there are no coordinate
windows and no stride, so no term is "far" and nothing falls back to a
gather path (``fn.far_terms`` is 0); arccos and atan2 are the hardware's,
so torsions take any periodicity and phase, in the IUPAC sign of
``forces.dihedral_angles``.

On CUDA tensors ``fn`` launches ``csrc/bonded.cu`` (one thread an atom
walking a per-atom CSR of the terms that touch it: row-owned gradient, no
atomics, float64 energy partials a CTA) or raises; on CPU tensors it runs
the plain version, ``md/analytic.py bonded_energy_and_forces``.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from .analytic import bonded_energy_and_forces, make_bonded_params
from .system import System

#: kernel launches made by this process (chip_smoke.py resets and reads it)
launches = {"bonded": 0}

_configured = False


def _library() -> ctypes.CDLL:
    global _configured
    lib = _kernels.library()
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pmarlo_bonded.argtypes = [p] * 9 + [i, i, p, p, p]
        lib.pmarlo_bonded.restype = i
        lib.pmarlo_bonded_blocks.argtypes = [i]
        lib.pmarlo_bonded_blocks.restype = i
        _configured = True
    return lib


def bonded_csr(bond_idx, angle_idx, torsion_idx, n_atoms: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-atom incidence lists of bonded terms: ``ptr (N + 1,)`` and
    ``entries (M, 2)`` of ``(type << 2 | role, term)``, type 0 bond, 1 angle,
    2 torsion, role = the atom's position in the term. An atom's entries are
    ordered by type, then term, then role, so its sum has a fixed order."""
    atoms, codes, terms = [], [], []
    for ttype, idx in enumerate((bond_idx, angle_idx, torsion_idx)):
        idx = np.asarray(idx, np.int64).reshape(-1, ttype + 2)
        n_terms, width = idx.shape
        atoms.append(idx.reshape(-1))
        codes.append(np.tile(ttype << 2 | np.arange(width), n_terms))
        terms.append(np.repeat(np.arange(n_terms), width))
    atoms = np.concatenate(atoms)
    order = np.argsort(atoms, kind="stable")
    ptr = np.zeros(n_atoms + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.bincount(atoms, minlength=n_atoms))
    ent = np.stack([np.concatenate(codes)[order], np.concatenate(terms)[order]], 1)
    return ptr, ent.astype(np.int32).reshape(-1, 2)


class BondedKernel:
    """``fn(x) -> (energy, grad)`` for the bonded potential of ``system``:
    ``x`` is ``(N, 3)`` or ``(R, N, 3)``, the energy comes back with the
    leading shape, ``grad`` is dE/dx. Built by ``build_bonded_window``."""

    #: terms sent to a fallback path: none, an indexed load reaches any atom
    far_terms = 0

    def __init__(self, system: System):
        self.system = system
        dev = system.device
        self.params = make_bonded_params(system)
        p = self.params
        self._bond_i = system.bond_idx.to(torch.int32).contiguous()
        self._bond_p = torch.stack([p.bond_k, p.bond_r0], 1).contiguous()
        self._angle_i = system.angle_idx.to(torch.int32).contiguous()
        self._angle_p = torch.stack([p.angle_k, p.angle_t0], 1).contiguous()
        self._tors_i = system.torsion_idx.to(torch.int32).contiguous()
        self._tors_p = torch.stack([p.tor_k, p.tor_n, p.tor_phase], 1).contiguous()
        ptr, ent = bonded_csr(system.bond_idx.cpu().numpy(), system.angle_idx.cpu().numpy(),
                              system.torsion_idx.cpu().numpy(), system.n_atoms)
        self._csr_ptr = torch.as_tensor(ptr, device=dev)
        self._csr_ent = torch.as_tensor(ent, device=dev).contiguous()

    def reference(self, x: torch.Tensor, energy_dtype=None):
        """The plain version on any device."""
        energy, forces = bonded_energy_and_forces(self.params, x, energy_dtype=energy_dtype)
        return energy, -forces

    def _launch(self, x: torch.Tensor, energy_dtype):
        n = self.system.n_atoms
        if x.device.type != "cuda" or x.device != self.system.device:
            raise RuntimeError(f"the bonded kernel runs on the system's CUDA device, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError("the bonded kernel takes float32 positions")
        xb = x.reshape(-1, n, 3).contiguous()
        lib = _library()
        R = xb.shape[0]
        grad = torch.empty_like(xb)
        partial = torch.empty((R, lib.pmarlo_bonded_blocks(n)), dtype=torch.float64,
                              device=x.device)
        rc = lib.pmarlo_bonded(
            xb.data_ptr(), self._bond_i.data_ptr(), self._bond_p.data_ptr(),
            self._angle_i.data_ptr(), self._angle_p.data_ptr(), self._tors_i.data_ptr(),
            self._tors_p.data_ptr(), self._csr_ptr.data_ptr(), self._csr_ent.data_ptr(),
            R, n, grad.data_ptr(), partial.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _kernels.check_launch(rc, "bonded")
        launches["bonded"] += 1
        energy = partial.sum(-1).to(energy_dtype or x.dtype)
        return energy.reshape(x.shape[:-2]), grad.reshape(x.shape)

    def __call__(self, x: torch.Tensor, energy_dtype=None):
        """Energy (in ``energy_dtype``, default the type of ``x``) and dE/dx:
        the kernel on a CUDA tensor, the plain version on a CPU tensor."""
        n = self.system.n_atoms
        if x.dim() < 2 or tuple(x.shape[-2:]) != (n, 3):
            raise ValueError(f"x must be (..., {n}, 3), got {tuple(x.shape)}")
        if x.device.type == "cpu":
            return self.reference(x, energy_dtype)
        return self._launch(x, energy_dtype)


def build_bonded_window(system: System) -> Optional[BondedKernel]:
    """The bonded function of ``system`` (tensors on ``system.device``), or
    ``None`` when the system has no bond, angle or torsion term."""
    if (system.bond_idx.shape[0] == 0 and system.angle_idx.shape[0] == 0
            and system.torsion_idx.shape[0] == 0):
        return None
    return BondedKernel(system)


__all__ = ["BondedKernel", "bonded_csr", "build_bonded_window", "launches"]
