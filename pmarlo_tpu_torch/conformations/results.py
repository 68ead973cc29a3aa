"""Frozen result dataclasses with JSON export
(reference: src/pmarlo/conformations/results.py:14,74,115,156,221).

Host copy of ``pmarlo_tpu/conformations/results.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..msm.tpt import TPTResult  # canonical TPT result lives in msm.tpt
from ..utils.json_io import write_json


@dataclasses.dataclass(frozen=True)
class KISResult:
    """(reference results.py:74)."""

    scores: np.ndarray               # (n_states,)
    n_slow_modes: int
    ranking: np.ndarray              # states sorted by score desc
    bootstrap_stability: Optional[float] = None  # mean rank correlation

    def to_dict(self) -> Dict:
        return {
            "scores": self.scores.tolist(),
            "n_slow_modes": self.n_slow_modes,
            "ranking": self.ranking.tolist(),
            "bootstrap_stability": self.bootstrap_stability,
        }


@dataclasses.dataclass(frozen=True)
class UncertaintyResult:
    """(reference results.py:115)."""

    observable_means: Dict[str, float]
    observable_cis: Dict[str, Tuple[float, float]]
    n_bootstrap: int
    ci_level: float

    def to_dict(self) -> Dict:
        return {
            "means": self.observable_means,
            "cis": {k: list(v) for k, v in self.observable_cis.items()},
            "n_bootstrap": self.n_bootstrap,
            "ci_level": self.ci_level,
        }


@dataclasses.dataclass(frozen=True)
class Conformation:
    """(reference results.py:156)."""

    state: int
    kind: str                        # "metastable" | "transition"
    macrostate: Optional[int]
    committor: float
    population: float
    kis_score: float
    representative: Optional[Dict] = None   # {"traj": i, "frame": j}
    pdb_path: Optional[str] = None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ConformationSet:
    """(reference results.py:221)."""

    conformations: Tuple[Conformation, ...]
    tpt: TPTResult
    kis: KISResult
    macrostate_assignments: np.ndarray
    uncertainty: Optional[UncertaintyResult] = None

    def metastable(self) -> List[Conformation]:
        return [c for c in self.conformations if c.kind == "metastable"]

    def transition_states(self) -> List[Conformation]:
        return [c for c in self.conformations if c.kind == "transition"]

    def to_dict(self) -> Dict:
        return {
            "conformations": [c.to_dict() for c in self.conformations],
            "tpt": self.tpt.to_dict(),
            "kis": self.kis.to_dict(),
            "macrostate_assignments": self.macrostate_assignments.tolist(),
            "uncertainty": self.uncertainty.to_dict() if self.uncertainty else None,
        }

    def save(self, path: "str | Path") -> Path:
        return write_json(path, self.to_dict())


__all__ = ["TPTResult", "KISResult", "UncertaintyResult", "Conformation",
           "ConformationSet"]
