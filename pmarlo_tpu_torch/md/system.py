"""The ``System``: every force-field parameter as a tensor on one device.

Port of ``pmarlo_tpu/md/system.py``. The fields and their meaning are the
JAX ``System``'s, field for field, so ``to_dict()`` of the two packages
compare directly; here they are torch tensors on an explicit ``device``.
``system_from_numpy`` carries a JAX ``System.to_dict()`` into the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import default_device

#: fields holding integer index arrays (int32 in both packages)
_INT_FIELDS = frozenset({
    "bond_idx", "angle_idx", "torsion_idx", "excl12_idx", "pair14_idx",
    "vsite_idx", "vsite_kind",
})


@dataclasses.dataclass(frozen=True)
class System:
    """Force-field parameters + topology metadata for one molecular system.

    Index tensors are int32, parameter tensors float32, all on ``device``.
    Units: kJ/mol, nm, ps, amu, elementary charge, radians.
    """

    # --- per-atom ---
    masses: torch.Tensor           # (N,) amu (after HMR if enabled)
    charges: torch.Tensor          # (N,) e
    # --- bonded terms ---
    bond_idx: torch.Tensor         # (NB, 2)
    bond_k: torch.Tensor           # (NB,) kJ/mol/nm^2  (E = 0.5 k (r-r0)^2)
    bond_r0: torch.Tensor          # (NB,) nm
    angle_idx: torch.Tensor        # (NA, 3)
    angle_k: torch.Tensor          # (NA,) kJ/mol/rad^2 (E = 0.5 k (t-t0)^2)
    angle_t0: torch.Tensor         # (NA,) rad
    torsion_idx: torch.Tensor      # (NT, 4)  (propers + impropers)
    torsion_k: torch.Tensor        # (NT,) kJ/mol      (E = k (1 + cos(n phi - phase)))
    torsion_n: torch.Tensor        # (NT,) periodicity (float)
    torsion_phase: torch.Tensor    # (NT,) rad
    # --- nonbonded (dense pairwise) ---
    lj_sigma: torch.Tensor         # (N,) nm
    lj_eps: torch.Tensor           # (N,) kJ/mol
    # --- GB implicit solvent (OBC/GBn2 family) ---
    gb_radii: torch.Tensor         # (N,) nm intrinsic Born radii (offset NOT applied)
    gb_screen: torch.Tensor        # (N,) HCT/GBn2 screening factors
    #: dense (N, N) pair-scale matrices (0 excluded, 1/1.2 or 1/2 for 1-4)
    scale_elec: Optional[torch.Tensor] = None
    scale_lj: Optional[torch.Tensor] = None
    #: per-atom tanh-rescale coefficients (GBn2); None -> OBC2 constants
    gb_alpha: Optional[torch.Tensor] = None
    gb_beta: Optional[torch.Tensor] = None
    gb_gamma: Optional[torch.Tensor] = None
    #: GBn2 neck-correction lookup per pair (None -> no neck term)
    gb_neck_d0: Optional[torch.Tensor] = None   # (N, N) nm
    gb_neck_m0: Optional[torch.Tensor] = None   # (N, N) 1/nm
    #: 1-2/1-3 exclusion pairs and 1-4 pairs
    excl12_idx: Optional[torch.Tensor] = None   # (P1, 2)
    pair14_idx: Optional[torch.Tensor] = None   # (P2, 2)
    #: virtual sites (not yet ported: ROADMAP queue A11)
    vsite_idx: Optional[torch.Tensor] = None
    vsite_weights: Optional[torch.Tensor] = None
    vsite_kind: Optional[torch.Tensor] = None
    # --- static metadata ---
    atom_names: Tuple[str, ...] = ()
    atom_types: Tuple[str, ...] = ()
    residue_names: Tuple[str, ...] = ()
    residue_ids: Tuple[int, ...] = ()
    solvent_dielectric: float = 78.5
    solute_dielectric: float = 1.0
    use_gb: bool = True
    gb_model: str = "obc2"
    gb_offset: float = 0.009
    gb_neck_scale: float = 0.0
    surface_tension: float = 28.3919551
    box: Optional[Tuple[float, float, float]] = None
    tilt: Optional[Tuple[float, float, float]] = None
    cutoff: float = 0.9
    switch_distance: Optional[float] = None

    @property
    def n_atoms(self) -> int:
        return int(self.masses.shape[0])

    @property
    def device(self) -> torch.device:
        return self.masses.device

    def atom_index(self, residue_id: int, atom_name: str) -> int:
        """Host-side lookup of an atom index by (residue id, atom name)."""
        for i, (rid, name) in enumerate(zip(self.residue_ids, self.atom_names)):
            if rid == residue_id and name == atom_name:
                return i
        raise KeyError(f"no atom {atom_name!r} in residue {residue_id}")

    def select(self, name: str) -> np.ndarray:
        """Indices of all atoms with the given atom name (e.g. 'CA')."""
        return np.asarray(
            [i for i, n in enumerate(self.atom_names) if n == name], dtype=np.int64
        )

    def to(self, device) -> "System":
        """The same system with every tensor on ``device``."""
        changes = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, Any]:
        """Fields as host numpy arrays (tensors) or plain values, keyed as
        JAX ``System.to_dict()`` keys them."""
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return d


def system_from_numpy(d: Dict[str, Any], device=None) -> System:
    """Build the port's ``System`` from a ``System.to_dict()`` of either
    package (arrays become tensors on ``device``: index arrays int32,
    parameters float32; static metadata passes through). ``device=None``
    is ``_device.default_device()``."""
    device = torch.device(device) if device is not None else default_device()
    kwargs = {}
    for f in dataclasses.fields(System):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, np.ndarray):
            dtype = torch.int32 if f.name in _INT_FIELDS else torch.float32
            v = torch.tensor(np.asarray(v), dtype=dtype, device=device)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return System(**kwargs)


def require_dense_scales(system: System, context: str) -> None:
    """Fail fast when a dense force path meets a system without (N, N)
    scale matrices."""
    if system.scale_elec is None or system.scale_lj is None:
        raise ValueError(
            f"{context} needs the dense (N, N) scale matrices, but this "
            f"System ({system.n_atoms} atoms) was built without them "
            "(dense_scales=False, the default past 12,000 atoms); the pair "
            "kernels, the periodic kernel and the cell-list kernel read the "
            "sparse exclusion lists instead."
        )


def require_no_vsites(system: System, context: str) -> None:
    """Virtual sites are not ported yet (ROADMAP queue A11)."""
    if system.vsite_idx is not None:
        raise NotImplementedError(
            f"{context}: virtual sites are not ported yet (ROADMAP queue A11)"
        )


def hydrogen_mass_repartition(
    masses: np.ndarray,
    bond_idx: np.ndarray,
    hydrogen_mass: float = 3.0,
    is_hydrogen: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Repartition mass from heavy atoms into bonded hydrogens (total mass
    conserved), as ``pmarlo_tpu.md.system.hydrogen_mass_repartition``."""
    masses = np.asarray(masses, dtype=np.float64).copy()
    started_massless = masses == 0.0
    if is_hydrogen is None:
        is_hydrogen = (masses > 0.0) & (masses < 2.0)
    for a, b in np.asarray(bond_idx):
        h, heavy = (a, b) if is_hydrogen[a] else (b, a)
        if not is_hydrogen[h] or is_hydrogen[heavy]:
            continue
        delta = hydrogen_mass - masses[h]
        masses[h] += delta
        masses[heavy] -= delta
    if np.any(masses[~started_massless] <= 0):
        raise ValueError("HMR drove a heavy-atom mass non-positive")
    return masses


__all__ = [
    "System", "system_from_numpy", "hydrogen_mass_repartition",
    "require_dense_scales", "require_no_vsites",
]
