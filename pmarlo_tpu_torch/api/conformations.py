"""Conformation export writers (reference: src/pmarlo/api/conformations.py:36).

Host copy of ``pmarlo_tpu/api/conformations.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import csv
from pathlib import Path

from ..conformations.results import ConformationSet
from ..utils.json_io import write_json


def conformations_to_csv(cs: ConformationSet, path: "str | Path") -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow([
            "state", "kind", "macrostate", "committor", "population",
            "kis_score", "traj", "frame", "pdb_path",
        ])
        for c in cs.conformations:
            rep = c.representative or {}
            writer.writerow([
                c.state, c.kind, c.macrostate, f"{c.committor:.6f}",
                f"{c.population:.6e}", f"{c.kis_score:.6e}",
                rep.get("traj", ""), rep.get("frame", ""), c.pdb_path or "",
            ])
    return path


def conformations_to_json(cs: ConformationSet, path: "str | Path") -> Path:
    return write_json(path, cs.to_dict())


def sanitize_label_for_filename(name: str) -> str:
    """Filesystem-safe conformation label (reference:
    src/pmarlo/api/conformations.py:116)."""
    return name.replace(":", "-").replace(" ", "_")


def _find_conformations_from_msm(*args, **kwargs):
    """Reference-named alias for conformations.finder.find_conformations
    (reference: src/pmarlo/api/conformations.py:33)."""
    from ..conformations.finder import find_conformations

    return find_conformations(*args, **kwargs)


find_conformations_from_msm = _find_conformations_from_msm

__all__ = [
    "conformations_to_csv", "conformations_to_json",
    "sanitize_label_for_filename", "find_conformations_from_msm",
]
