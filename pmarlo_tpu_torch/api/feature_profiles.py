"""Named feature profiles with CV-biasing compatibility validation
(reference: src/pmarlo/api/feature_profiles.py:36-178).

Host copy of ``pmarlo_tpu/api/feature_profiles.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class FeatureProfile:
    name: str
    spec: Tuple[str, ...]
    description: str
    bias_compatible: bool     # usable inside the per-step CV bias graph
    periodic_only: bool = False


FEATURE_PROFILES: Dict[str, FeatureProfile] = {
    p.name: p
    for p in [
        FeatureProfile(
            name="backbone",
            spec=("phi_psi",),
            description="Backbone phi/psi dihedrals (cos/sin expandable)",
            bias_compatible=True,
            periodic_only=True,
        ),
        FeatureProfile(
            name="backbone_chi1",
            spec=("phi_psi", "chi1"),
            description="Backbone + chi1 side-chain dihedrals",
            bias_compatible=True,
            periodic_only=True,
        ),
        FeatureProfile(
            name="compactness",
            spec=("rg", "ca_distances"),
            description="Radius of gyration + CA pair distances",
            bias_compatible=True,
        ),
        FeatureProfile(
            name="contacts",
            spec=("contacts",),
            description="Smooth CA contact indicators",
            bias_compatible=True,
        ),
        FeatureProfile(
            name="universal",
            spec=("phi_psi", "rg", "ca_distances"),
            description="Pooled universal metric feature set",
            bias_compatible=False,  # mixed periodicity; analysis only
        ),
    ]
}


def get_feature_profile(name: str, for_bias: bool = False) -> FeatureProfile:
    """Look up a profile; with ``for_bias`` reject analysis-only profiles
    (the reference's CV-biasing compatibility validation)."""
    key = name.lower()
    if key not in FEATURE_PROFILES:
        raise KeyError(
            f"unknown feature profile {name!r}; available: {sorted(FEATURE_PROFILES)}"
        )
    profile = FEATURE_PROFILES[key]
    if for_bias and not profile.bias_compatible:
        raise ValueError(
            f"profile {name!r} is not CV-bias compatible "
            "(mixed/discontinuous features cannot drive per-step bias forces)"
        )
    return profile


def _feature_entry_to_spec(entry: dict) -> str:
    """Map one YAML feature entry ({type, atom_indices}) onto the spec
    grammar understood by features.base.parse_feature_spec."""
    ftype = str(entry.get("type") or "").strip().lower()
    idx = list(entry.get("atom_indices") or [])
    arity = {"distance": 2, "angle": 3, "dihedral": 4}
    if ftype in arity:
        if len(idx) != arity[ftype]:
            raise ValueError(
                f"{ftype} feature needs {arity[ftype]} atom_indices, got {idx}"
            )
        return f"{ftype}([{', '.join(str(int(i)) for i in idx)}])"
    if ftype:
        return ftype  # bare registered feature name (phi_psi, rg, ...)
    raise ValueError(f"feature entry must carry a 'type': {entry!r}")


def load_feature_profile(
    profile_name: str, spec_path: "str | None" = None
) -> FeatureProfile:
    """Load a named profile; ``molecular_custom`` builds its spec from a
    YAML feature file with {type, atom_indices} entries (reference:
    src/pmarlo/api/feature_profiles.py:79)."""
    if profile_name == "molecular_custom":
        if spec_path is None:
            raise ValueError("spec_path is required for molecular_custom profile")
        from pathlib import Path

        import yaml

        from ..features.base import parse_feature_spec

        p = Path(spec_path)
        if not p.exists():
            raise FileNotFoundError(f"Feature specification not found: {p}")
        raw = yaml.safe_load(p.read_text()) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"Feature specification root must be a mapping: {p}")
        specs = []
        for entry in raw.get("features", []):
            if not isinstance(entry, dict):
                raise ValueError("Feature specification entries must be mappings")
            specs.append(_feature_entry_to_spec(entry))
        parse_feature_spec(specs)  # fail fast on grammar errors
        return FeatureProfile(
            name="molecular_custom",
            spec=tuple(specs),
            description=f"Custom features from {p.name}",
            bias_compatible=True,  # distance/angle/dihedral are in-graph
        )
    return get_feature_profile(profile_name)


def get_feature_profile_info(
    profile_name: str, spec_path: "str | None" = None
) -> dict:
    """Metadata for a named profile (reference feature_profiles.py:134)."""
    key = profile_name.lower()
    if key != "molecular_custom" and key not in FEATURE_PROFILES:
        return {"exists": False, "name": profile_name}
    info: dict = {"exists": True, "name": key}
    if key == "molecular_custom":
        info["spec_path"] = str(spec_path) if spec_path is not None else None
        info["spec_status"] = "spec_path_not_provided"
        info["cv_biasing_compatible"] = True
        info["feature_count"] = "variable"
        if spec_path is not None:
            try:
                prof = load_feature_profile(key, spec_path)
            except FileNotFoundError:
                info["spec_status"] = "spec_file_missing"
            except ValueError as exc:
                info["spec_status"] = f"invalid: {exc}"
            else:
                info["spec_status"] = "ok"
                info["features"] = list(prof.spec)
                info["feature_count"] = len(prof.spec)
                info["description"] = prof.description
        return info
    prof = FEATURE_PROFILES[key]
    info.update(dataclasses.asdict(prof))
    info["cv_biasing_compatible"] = prof.bias_compatible
    info["feature_count"] = len(prof.spec)
    return info


def validate_profile_for_cv_biasing(profile_name: str) -> "Tuple[bool, str]":
    """(ok, reason) for using a profile inside the per-step CV bias graph
    (reference feature_profiles.py:167)."""
    info = get_feature_profile_info(profile_name)
    if not info["exists"]:
        return False, f"Unknown profile: {profile_name}"
    if not info["cv_biasing_compatible"]:
        return False, (
            f"Profile {profile_name!r} mixes periodicities/discontinuous "
            "features; it cannot drive per-step bias forces"
        )
    return True, "Profile is compatible with CV biasing"


__all__ = [
    "FeatureProfile", "FEATURE_PROFILES", "get_feature_profile",
    "load_feature_profile", "get_feature_profile_info",
    "validate_profile_for_cv_biasing",
]
