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

On CUDA tensors ``fn`` launches ``csrc/bonded.cu`` or raises: a term pass
(one thread a term, every role's gradient to the incidence's slot in the
per-atom CSR, float64 energy partials a CTA) and an atom pass (each atom's
slots added in CSR order); no atomics. On CPU tensors it runs the plain
version, ``md/analytic.py bonded_energy_and_forces``. ``launches`` counts
calls that launched the kernel, one an evaluation.
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
        lib.pmarlo_bonded.argtypes = [p] * 7 + [i, i, i, p, p, i, i, p, p, p, p]
        lib.pmarlo_bonded.restype = i
        lib.pmarlo_bonded_blocks.argtypes = [i, i, i]
        lib.pmarlo_bonded_blocks.restype = i
        _configured = True
    return lib


def _incidences(bond_idx, angle_idx, torsion_idx):
    """Atoms, codes ``type << 2 | role`` and terms of every (term, role)
    incidence, type-major (bonds, angles, torsions), then term, then role."""
    atoms, codes, terms = [], [], []
    for ttype, idx in enumerate((bond_idx, angle_idx, torsion_idx)):
        idx = np.asarray(idx, np.int64).reshape(-1, ttype + 2)
        n_terms, width = idx.shape
        atoms.append(idx.reshape(-1))
        codes.append(np.tile(ttype << 2 | np.arange(width), n_terms))
        terms.append(np.repeat(np.arange(n_terms), width))
    return np.concatenate(atoms), np.concatenate(codes), np.concatenate(terms)


def _csr_order(atoms: np.ndarray, n_atoms: int) -> Tuple[np.ndarray, np.ndarray]:
    """``ptr (N + 1,)`` of the per-atom CSR and the stable order that puts
    the incidences of ``atoms`` into it."""
    ptr = np.zeros(n_atoms + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.bincount(atoms, minlength=n_atoms))
    return ptr, np.argsort(atoms, kind="stable")


def bonded_csr(bond_idx, angle_idx, torsion_idx, n_atoms: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-atom incidence lists of bonded terms: ``ptr (N + 1,)`` and
    ``entries (M, 2)`` of ``(type << 2 | role, term)``, type 0 bond, 1 angle,
    2 torsion, role = the atom's position in the term. An atom's entries are
    ordered by type, then term, then role, so its sum has a fixed order."""
    atoms, codes, terms = _incidences(bond_idx, angle_idx, torsion_idx)
    ptr, order = _csr_order(atoms, n_atoms)
    ent = np.stack([codes[order], terms[order]], 1)
    return ptr, ent.astype(np.int32).reshape(-1, 2)


def bonded_slots(bond_idx, angle_idx, torsion_idx,
                 n_atoms: int) -> Tuple[np.ndarray, np.ndarray]:
    """``bonded_csr``'s ``ptr`` and ``slot (M,)`` int32: the position in its
    entries of each (term, role) incidence, incidences type-major, then
    term, then role (bond b's role k is incidence 2 b + k, angle a's
    2 NB + 3 a + k, torsion t's 2 NB + 3 NA + 4 t + k). The kernel's term
    pass writes role k's gradient there, so that each atom's range holds
    its shares."""
    atoms, _, _ = _incidences(bond_idx, angle_idx, torsion_idx)
    ptr, order = _csr_order(atoms, n_atoms)
    slot = np.empty(atoms.shape[0], dtype=np.int32)
    slot[order] = np.arange(atoms.shape[0], dtype=np.int32)
    return ptr, slot


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
        tables = [t.cpu().numpy() for t in (system.bond_idx, system.angle_idx,
                                             system.torsion_idx)]
        self._counts = tuple(int(t.shape[0]) for t in tables)
        ptr, slot = bonded_slots(*tables, system.n_atoms)
        self._csr_ptr = torch.as_tensor(ptr, device=dev)
        self._slot_of = torch.as_tensor(slot, device=dev)
        #: (term, role) incidences: the rows of the kernel's slot scratch
        self.incidences = int(self._slot_of.shape[0])
        self._blocks = None

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
        if self._blocks is None:
            self._blocks = lib.pmarlo_bonded_blocks(*self._counts)
        slots = torch.empty((R, self.incidences, 4), dtype=torch.float32, device=x.device)
        grad = torch.empty_like(xb)
        # each term-pass CTA's energy, then their sum
        partial = torch.empty((R, self._blocks + 1), dtype=torch.float64, device=x.device)
        rc = lib.pmarlo_bonded(
            xb.data_ptr(), self._bond_i.data_ptr(), self._bond_p.data_ptr(),
            self._angle_i.data_ptr(), self._angle_p.data_ptr(), self._tors_i.data_ptr(),
            self._tors_p.data_ptr(), *self._counts, self._slot_of.data_ptr(),
            self._csr_ptr.data_ptr(), R, n, slots.data_ptr(), grad.data_ptr(),
            partial.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
        _kernels.check_launch(rc, "bonded")
        launches["bonded"] += 1
        energy = partial[:, -1].to(energy_dtype or x.dtype)
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


__all__ = ["BondedKernel", "bonded_csr", "bonded_slots", "build_bonded_window", "launches"]
