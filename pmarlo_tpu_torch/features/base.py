"""Feature registry + string-spec mini-language.

Port of ``pmarlo_tpu/features/base.py`` (features return tensors on the
trajectory's device). API-compatible rebuild of the reference registry
(src/pmarlo/features/base.py:21-47 FEATURE_REGISTRY/register_feature/
get_feature; :129 parse_feature_spec). Specs like::

    "phi_psi"
    "distance(1,7)" / "dist:atompair(1,7)"
    "ca_distances"
    "rg"
    "contacts"
    "dihedral(0,1,2,3)"

A feature object is a callable ``feature(traj, topology_info) -> (T, K)``
plus per-column periodicity flags (used for cos/sin expansion and periodic
FES ranges).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import builtins as B


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """A parsed feature request: name + positional int args."""

    name: str
    args: Tuple[int, ...] = ()

    def canonical(self) -> str:
        return self.name if not self.args else f"{self.name}({','.join(map(str, self.args))})"


@dataclasses.dataclass
class TopologyInfo:
    """Static per-system info features need (host-side, hashable arrays)."""

    atom_names: Sequence[str]
    residue_names: Sequence[str]
    residue_ids: Sequence[int]
    masses: Optional[np.ndarray] = None
    bonds: Optional[np.ndarray] = None   # (NB, 2) — needed by hbonds/sasa
    #: per-atom chain ids: keeps phi/psi/DSSP from spanning chain
    #: boundaries when residue numbering continues across chains
    chain_ids: Optional[Sequence[str]] = None

    @classmethod
    def from_topology(cls, topology) -> "TopologyInfo":
        """Build from an md.topology.Topology."""
        return cls(
            atom_names=topology.atom_names,
            residue_names=topology.residue_names,
            residue_ids=topology.residue_ids,
            bonds=np.asarray(topology.bonds),
            chain_ids=getattr(topology, "chain_ids", None),
        )


class Feature:
    """A named featurizer: __call__(traj, top) -> (T, K) with periodicity."""

    name: str = ""

    def __call__(self, traj, top: TopologyInfo):  # pragma: no cover - interface
        raise NotImplementedError

    def periodic(self, top: TopologyInfo) -> np.ndarray:
        """Per-output-column periodicity flags (default: aperiodic)."""
        return np.zeros(self.n_outputs(top), dtype=bool)

    def n_outputs(self, top: TopologyInfo) -> int:  # pragma: no cover - interface
        raise NotImplementedError


FEATURE_REGISTRY: Dict[str, Callable[..., Feature]] = {}


def register_feature(name: str, factory: Optional[Callable[..., Feature]] = None):
    """Register a feature factory under a case-insensitive name
    (decorator or direct call, reference features/base.py:21-47)."""

    def _register(f):
        key = name.lower()
        if key in FEATURE_REGISTRY:
            raise ValueError(f"feature {key!r} already registered")
        FEATURE_REGISTRY[key] = f
        return f

    return _register(factory) if factory is not None else _register


def get_feature(name: str, *args) -> Feature:
    key = name.lower()
    if key not in FEATURE_REGISTRY:
        raise KeyError(
            f"unknown feature {name!r}; registered: {sorted(FEATURE_REGISTRY)}"
        )
    return FEATURE_REGISTRY[key](*args)


_SPEC_RE = re.compile(
    r"^\s*(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"(?:\s*[:(]\s*(?:atompair\s*\()?\s*(?P<args>[-0-9,\s\[\]]*?)\s*\)?\s*\)?)?\s*$"
)


def parse_feature_spec(spec: "str | Sequence[str]") -> List[FeatureSpec]:
    """Parse a spec string (or list) into FeatureSpec items.

    Accepts the reference grammar (features/base.py:129): bare names,
    ``dist:atompair(i,j)``, ``distance([i,j])``, comma-joined lists.
    """
    if isinstance(spec, str):
        items = [s for s in re.split(r"[;+]", spec) if s.strip()]
        # a single comma-joined string of bare names is also allowed
        if len(items) == 1 and "(" not in items[0] and "," in items[0]:
            items = [s for s in items[0].split(",") if s.strip()]
    else:
        items = [str(s) for s in spec]
    out: List[FeatureSpec] = []
    for item in items:
        m = _SPEC_RE.match(item)
        if not m:
            raise ValueError(f"cannot parse feature spec {item!r}")
        name = m.group("name").lower()
        if name == "dist":
            name = "distance"
        raw_args = (m.group("args") or "").replace("[", "").replace("]", "")
        args = tuple(int(a) for a in raw_args.split(",") if a.strip())
        out.append(FeatureSpec(name=name, args=args))
    return out


# --- built-in feature classes -------------------------------------------------

@register_feature("phi_psi")
class PhiPsiFeature(Feature):
    """Backbone phi/psi dihedrals, wrapped to (-pi, pi]
    (reference builtins.py:42)."""

    name = "phi_psi"

    def __call__(self, traj, top: TopologyInfo):
        phi_q, psi_q, _ = B.phi_psi_indices(top.atom_names, top.residue_ids, top.chain_ids)
        quads = np.concatenate([phi_q, psi_q], axis=0)
        if quads.shape[0] == 0:
            raise ValueError("system has no phi/psi dihedrals")
        return B.compute_dihedrals(traj, quads)

    def n_outputs(self, top: TopologyInfo) -> int:
        phi_q, psi_q, _ = B.phi_psi_indices(top.atom_names, top.residue_ids, top.chain_ids)
        return phi_q.shape[0] + psi_q.shape[0]

    def periodic(self, top: TopologyInfo) -> np.ndarray:
        return np.ones(self.n_outputs(top), dtype=bool)


@register_feature("backbone_torsions")
class BackboneTorsionsFeature(Feature):
    """phi + psi + omega dihedrals (reference featurize.py
    'backbone_torsions' matrix)."""

    name = "backbone_torsions"

    def _quads(self, top: TopologyInfo) -> np.ndarray:
        phi_q, psi_q, _ = B.phi_psi_indices(top.atom_names, top.residue_ids, top.chain_ids)
        omega_q, _ = B.omega_indices(top.atom_names, top.residue_ids, top.chain_ids)
        return np.concatenate([phi_q, psi_q, omega_q], axis=0)

    def __call__(self, traj, top: TopologyInfo):
        quads = self._quads(top)
        if quads.shape[0] == 0:
            raise ValueError("system has no backbone torsions")
        return B.compute_dihedrals(traj, quads)

    def n_outputs(self, top: TopologyInfo) -> int:
        return self._quads(top).shape[0]

    def periodic(self, top: TopologyInfo) -> np.ndarray:
        return np.ones(self.n_outputs(top), dtype=bool)


@register_feature("chi1")
class Chi1Feature(Feature):
    name = "chi1"

    def __call__(self, traj, top: TopologyInfo):
        quads, _ = B.chi1_indices(top.atom_names, top.residue_names, top.residue_ids)
        if quads.shape[0] == 0:
            raise ValueError("system has no chi1 dihedrals")
        return B.compute_dihedrals(traj, quads)

    def n_outputs(self, top: TopologyInfo) -> int:
        quads, _ = B.chi1_indices(top.atom_names, top.residue_names, top.residue_ids)
        return quads.shape[0]

    def periodic(self, top: TopologyInfo) -> np.ndarray:
        return np.ones(self.n_outputs(top), dtype=bool)


@register_feature("rg")
class RadiusOfGyrationFeature(Feature):
    name = "rg"

    def __call__(self, traj, top: TopologyInfo):
        return B.radius_of_gyration(traj, top.masses)[:, None]

    def n_outputs(self, top: TopologyInfo) -> int:
        return 1


@register_feature("distance")
class DistanceFeature(Feature):
    name = "distance"

    def __init__(self, *atoms: int):
        if len(atoms) != 2:
            raise ValueError(f"distance feature needs 2 atom indices, got {atoms}")
        self.pair = np.asarray([atoms], dtype=np.int32)

    def __call__(self, traj, top: TopologyInfo):
        return B.compute_distances(traj, self.pair)

    def n_outputs(self, top: TopologyInfo) -> int:
        return 1


@register_feature("angle")
class AngleFeature(Feature):
    name = "angle"

    def __init__(self, *atoms: int):
        if len(atoms) != 3:
            raise ValueError(f"angle feature needs 3 atom indices, got {atoms}")
        self.triple = np.asarray([atoms], dtype=np.int32)

    def __call__(self, traj, top: TopologyInfo):
        return B.compute_angles(traj, self.triple)

    def n_outputs(self, top: TopologyInfo) -> int:
        return 1


@register_feature("dihedral")
class DihedralFeature(Feature):
    name = "dihedral"

    def __init__(self, *atoms: int):
        if len(atoms) != 4:
            raise ValueError(f"dihedral feature needs 4 atom indices, got {atoms}")
        self.quad = np.asarray([atoms], dtype=np.int32)

    def __call__(self, traj, top: TopologyInfo):
        return B.compute_dihedrals(traj, self.quad)

    def n_outputs(self, top: TopologyInfo) -> int:
        return 1

    def periodic(self, top: TopologyInfo) -> np.ndarray:
        return np.ones(1, dtype=bool)


@register_feature("ca_distances")
class CADistancesFeature(Feature):
    name = "ca_distances"

    def __init__(self, stride: int = 1):
        self.stride = max(int(stride), 1)

    def __call__(self, traj, top: TopologyInfo):
        pairs = B.ca_pair_indices(top.atom_names, top.residue_ids, self.stride)
        if pairs.shape[0] == 0:
            raise ValueError("system has fewer than two CA atoms")
        return B.compute_distances(traj, pairs)

    def n_outputs(self, top: TopologyInfo) -> int:
        return B.ca_pair_indices(top.atom_names, top.residue_ids, self.stride).shape[0]


@register_feature("contacts")
class ContactsFeature(Feature):
    name = "contacts"

    def __init__(self, stride: int = 1):
        self.stride = max(int(stride), 1)

    def __call__(self, traj, top: TopologyInfo):
        pairs = B.ca_pair_indices(top.atom_names, top.residue_ids, self.stride)
        return B.contacts(traj, pairs)

    def n_outputs(self, top: TopologyInfo) -> int:
        return B.ca_pair_indices(top.atom_names, top.residue_ids, self.stride).shape[0]


__all__ = [
    "FEATURE_REGISTRY",
    "Feature",
    "FeatureSpec",
    "TopologyInfo",
    "register_feature",
    "get_feature",
    "parse_feature_spec",
]
