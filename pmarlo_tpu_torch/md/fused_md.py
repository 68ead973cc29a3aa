"""Fused multi-step Langevin chunk: a CUDA kernel and its plain twin.

Port of ``pmarlo_tpu/md/pallas_md.py build_pallas_chunk`` (unbiased).
``build_fused_chunk`` returns a ``FusedChunk``; calling it advances every
replica ``n_steps`` folded-BAOAB steps and returns the energies at the
final positions:

    chunk(x, v, seeds, temps, n_steps, step_offset) -> (x, v, energies)

- tensors on a CUDA device launch ``csrc/fused_md.cu`` (one launch per
  call; the module counter ``launches`` counts them). A CUDA tensor never
  reaches the plain version: the launch happens or the call raises.
- tensors on the CPU run ``FusedChunk.reference``: ``langevin_step`` over
  ``analytic.energy_and_forces``, with the same Philox noise stream.

``n_steps`` is a runtime argument (no per-size prebuild), and
``step_offset`` is the global index of the first step, which keys the
noise: successive windows must pass successive offsets.

The kernel library is compiled with ``nvcc`` from ``pmarlo_tpu_torch/csrc``
at first use (``_kernels.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from .. import _kernels
from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from .analytic import energy_and_forces, make_dense_params
from .integrate import MDState, langevin_step
from .system import System

#: kernel launches made by this process (chip_smoke.py resets and reads it)
launches = 0

#: atoms per replica the kernel takes: one thread per atom in one CTA, and
#: one SM's register file holds 512 threads at the kernel's register count
MAX_ATOMS = 512

_configured = False


def _library() -> ctypes.CDLL:
    global _configured
    lib = _kernels.library()
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        f = ctypes.c_float
        lib.pmarlo_fused_md_chunk.argtypes = (
            [p] * 16 + [i, i, i, ctypes.c_longlong] + [f] * 5 + [i, i, p]
        )
        lib.pmarlo_fused_md_chunk.restype = i
        lib.pmarlo_fused_md_max_atoms.argtypes = []
        lib.pmarlo_fused_md_max_atoms.restype = i
        if lib.pmarlo_fused_md_max_atoms() != MAX_ATOMS:
            raise RuntimeError("kernel library and wrapper disagree on MAX_ATOMS")
        _configured = True
    return lib


def _bonded_csr(system: System) -> Tuple[np.ndarray, np.ndarray]:
    """Per-atom incidence lists of bonded terms: ``ptr (N+1,)`` and
    ``entries (M, 2)`` of ``(type << 2 | role, term)``, type 0 bond,
    1 angle, 2 torsion, role = the atom's position in the term."""
    per_atom = [[] for _ in range(system.n_atoms)]
    for ttype, idx in enumerate(
        (system.bond_idx, system.angle_idx, system.torsion_idx)
    ):
        for term, atoms in enumerate(idx.detach().cpu().numpy()):
            for role, atom in enumerate(atoms):
                per_atom[int(atom)].append((ttype << 2 | role, term))
    ptr = np.zeros(system.n_atoms + 1, dtype=np.int32)
    ptr[1:] = np.cumsum([len(e) for e in per_atom])
    ent = np.asarray([e for lst in per_atom for e in lst], dtype=np.int32)
    return ptr, ent.reshape(-1, 2)


class FusedChunk:
    """K-step Langevin chunk for all replicas of one system (see module
    docstring). Built by ``build_fused_chunk``."""

    def __init__(self, system: System, *, dt: float, friction: float, n_replicas: int):
        if system.n_atoms > MAX_ATOMS:
            raise ValueError(
                f"the fused kernel holds one replica in one CTA, one thread "
                f"per atom: N = {system.n_atoms} exceeds {MAX_ATOMS}"
            )
        self.system = system
        self.dt = float(dt)
        self.friction = float(friction)
        self.n_replicas = int(n_replicas)
        self.dense = make_dense_params(system)
        p = self.dense
        n = system.n_atoms
        dev = system.device
        zeros_nn = torch.zeros((n, n), dtype=torch.float32, device=dev)
        inv_m = torch.where(p.masses > 0.0, 1.0 / p.masses, torch.zeros_like(p.masses))
        self._atom_p = torch.stack([
            inv_m, p.q, p.gb_rho, p.gb_sr, p.gb_radii,
            p.gb_alpha, p.gb_beta, p.gb_gamma, p.sa_coef,
        ]).contiguous()
        use_neck = p.use_neck
        self._pair_p = torch.stack([
            p.lj_a, p.lj_b, p.qq_scaled, p.qq_full,
            p.neck_d0 if use_neck else zeros_nn,
            p.neck_scale * p.neck_m0 if use_neck else zeros_nn,
        ]).contiguous()
        self._bond_i = system.bond_idx.to(torch.int32).contiguous()
        self._bond_p = torch.stack([p.bond_k, p.bond_r0], 1).contiguous()
        self._angle_i = system.angle_idx.to(torch.int32).contiguous()
        self._angle_p = torch.stack([p.angle_k, p.angle_t0], 1).contiguous()
        self._tors_i = system.torsion_idx.to(torch.int32).contiguous()
        self._tors_p = torch.stack([p.tor_k, p.tor_n, p.tor_phase], 1).contiguous()
        ptr, ent = _bonded_csr(system)
        self._csr_ptr = torch.as_tensor(ptr, device=dev)
        self._csr_ent = torch.as_tensor(ent, device=dev).contiguous()
        self._use_neck = int(use_neck)
        self.c1 = math.exp(-self.friction * self.dt)

    # --- plain PyTorch version ------------------------------------------------

    def reference(self, x, v, seeds, temps, n_steps: int, step_offset: int = 0):
        """Plain PyTorch twin: ``langevin_step`` over the analytic forces,
        the kernel's noise stream, energies at the final positions."""
        self._check(x, v, seeds, temps, n_steps)
        state = MDState(positions=x, velocities=v, seeds=seeds, step=int(step_offset))
        force_fn = lambda y: energy_and_forces(self.dense, y)  # noqa: E731
        for _ in range(int(n_steps)):
            state, _ = langevin_step(
                self.system, state, dt=self.dt, friction=self.friction,
                temperature_K=temps, force_fn=force_fn,
            )
        energies, _ = energy_and_forces(self.dense, state.positions)
        return state.positions, state.velocities, energies

    # --- dispatch ---------------------------------------------------------------

    def __call__(self, x, v, seeds, temps, n_steps: int, step_offset: int = 0):
        if x.device.type == "cpu":
            return self.reference(x, v, seeds, temps, n_steps, step_offset)
        xo, vo, eo, _ = self._launch(x, v, seeds, temps, n_steps, step_offset, False)
        return xo, vo, eo

    def energy_and_forces(self, x: torch.Tensor):
        """Energies ``(R,)`` and forces ``(R, N, 3)`` at ``x``: the kernel
        with zero steps on a CUDA tensor, the analytic twin on the CPU."""
        if x.device.type == "cpu":
            return energy_and_forces(self.dense, x)
        R = x.shape[0]
        v = torch.zeros_like(x)
        seeds = torch.zeros(R, dtype=torch.int32, device=x.device)
        temps = torch.zeros(R, dtype=torch.float32, device=x.device)
        _, _, eo, fo = self._launch(x, v, seeds, temps, 0, 0, True)
        return eo, fo

    def _check(self, x, v, seeds, temps, n_steps):
        n = self.system.n_atoms
        if x.dim() != 3 or tuple(x.shape[1:]) != (n, 3):
            raise ValueError(f"x must be (R, {n}, 3), got {tuple(x.shape)}")
        R = x.shape[0]
        if R != self.n_replicas:
            raise ValueError(f"chunk built for {self.n_replicas} replicas, got {R}")
        if v.shape != x.shape:
            raise ValueError(f"v {tuple(v.shape)} must match x {tuple(x.shape)}")
        if tuple(seeds.shape) != (R,) or tuple(temps.shape) != (R,):
            raise ValueError("seeds and temps must be (R,)")
        if x.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("x and v must be float32")
        if seeds.dtype != torch.int32:
            raise TypeError("seeds must be int32")
        if int(n_steps) < 0:
            raise ValueError("n_steps must be >= 0")
        for t in (v, seeds, temps):
            if t.device != x.device:
                raise ValueError("x, v, seeds and temps must share one device")
        if x.device != self.system.device:
            raise ValueError(
                f"tensors on {x.device} but the chunk was built for "
                f"{self.system.device}"
            )

    def _launch(self, x, v, seeds, temps, n_steps, step_offset, want_forces):
        global launches
        if x.device.type != "cuda":
            raise RuntimeError(f"the fused kernel runs on CUDA tensors, got {x.device}")
        self._check(x, v, seeds, temps, n_steps)
        lib = _library()
        R, n = x.shape[0], self.system.n_atoms
        xo = x.contiguous().clone()
        vo = v.contiguous().clone()
        eo = torch.empty(R, dtype=torch.float32, device=x.device)
        fo = torch.empty_like(xo) if want_forces else None
        kT = (BOLTZMANN_CONSTANT_KJ_PER_MOL * temps.to(torch.float32)).contiguous()
        seeds_c = seeds.contiguous()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pmarlo_fused_md_chunk(
            xo.data_ptr(), vo.data_ptr(), eo.data_ptr(),
            fo.data_ptr() if fo is not None else None,
            seeds_c.data_ptr(), kT.data_ptr(),
            self._atom_p.data_ptr(), self._pair_p.data_ptr(),
            self._bond_i.data_ptr(), self._bond_p.data_ptr(),
            self._angle_i.data_ptr(), self._angle_p.data_ptr(),
            self._tors_i.data_ptr(), self._tors_p.data_ptr(),
            self._csr_ptr.data_ptr(), self._csr_ent.data_ptr(),
            R, n, int(n_steps), int(step_offset),
            self.dt, 0.5 * self.dt, self.c1, 1.0 - self.c1 * self.c1,
            self.dense.gb_pref, int(self.dense.use_gb), self._use_neck,
            stream,
        )
        _kernels.check_launch(rc, "fused_md_chunk")
        launches += 1
        return xo, vo, eo, fo


def build_fused_chunk(system: System, *, dt: float, friction: float,
                      n_replicas: int) -> FusedChunk:
    """The fused chunk for ``system`` (tensors on ``system.device``)."""
    return FusedChunk(system, dt=dt, friction=friction, n_replicas=n_replicas)


__all__ = ["FusedChunk", "build_fused_chunk",
           "MAX_ATOMS", "launches"]
