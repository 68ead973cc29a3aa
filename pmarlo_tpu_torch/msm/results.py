"""Versioned result containers with dict/json/pickle round-trips.

Reference: src/pmarlo/markov_state_model/results.py:19 (BaseResult with
version check), :112 (MSMResult), :135 (ITSResult), :149
(CKITSSelectionResult). The concrete MSM/ITS/CK/FES results live with
their estimators (estimation.py, its.py, ck.py, free_energy.py); this
module provides the shared persistence base and re-exports.

Host copy of ``pmarlo_tpu/msm/results.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from pathlib import Path
from typing import Any, Dict, Type, TypeVar

import numpy as np

from ..utils.json_io import sanitize_for_json
from .ck import CKResult
from .clustering import ClusteringResult
from .estimation import MSMResult
from .free_energy import FESResult, PMFResult
from .its import ITSResult

SCHEMA_VERSION = 1
T = TypeVar("T", bound="BaseResult")


@dataclasses.dataclass
class BaseResult:
    """Persistence base (reference results.py:19)."""

    version: int = SCHEMA_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return sanitize_for_json(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
        if data.get("version", 1) > SCHEMA_VERSION:
            raise ValueError(
                f"{cls.__name__} version {data.get('version')} is newer than "
                f"supported {SCHEMA_VERSION}"
            )
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})

    def save_json(self, path: "str | Path") -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2))
        return path

    @classmethod
    def load_json(cls: Type[T], path: "str | Path") -> T:
        return cls.from_dict(json.loads(Path(path).read_text()))

    def save_pickle(self, path: "str | Path") -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pickle.dumps(self))
        return path

    @classmethod
    def load_pickle(cls: Type[T], path: "str | Path") -> T:
        obj = pickle.loads(Path(path).read_bytes())
        if not isinstance(obj, cls):
            raise TypeError(f"{path} contained {type(obj).__name__}, not {cls.__name__}")
        return obj


__all__ = [
    "BaseResult",
    "SCHEMA_VERSION",
    "MSMResult",
    "ITSResult",
    "CKResult",
    "FESResult",
    "PMFResult",
    "ClusteringResult",
]
