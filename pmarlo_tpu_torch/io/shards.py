"""Shard store: the append-only dataset of simulation segments.

Reconstructs the removed ``pmarlo.shards`` / ``pmarlo.data.shard_io``
subsystem from its documented contract (reference CHANGELOG.md:42,52-57,
103-104,123): canonical shard IDs ``T{temp}_run-{run_id}``, JSON metadata
with feature specs + hash, ``source.range`` frame spans, stride, and bias
provenance. A shard is one npz (features and/or coordinates) + one JSON
sidecar; shards are the checkpoint/resume unit of the sampling loop.

Host copy of ``pmarlo_tpu/io/shards.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.json_io import sanitize_for_json

SCHEMA_VERSION = 1


def shard_id(temperature_K: float, run_id: str, index: Optional[int] = None) -> str:
    """Canonical shard ID ``T{temp}_run-{run_id}[_{index}]``
    (reference CHANGELOG.md:42)."""
    base = f"T{temperature_K:g}_run-{run_id}"
    return base if index is None else f"{base}_{index:05d}"


def feature_spec_hash(spec: Sequence[str]) -> str:
    """SHA-256 over the canonical feature spec (reference
    ts_feature_extractor.py:283 canonicalization + hashing)."""
    canon = json.dumps([str(s) for s in spec], separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def write_shard(
    directory: "str | Path",
    *,
    temperature_K: float,
    run_id: str,
    features: Optional[np.ndarray] = None,
    coordinates: Optional[np.ndarray] = None,
    feature_spec: Optional[Sequence[str]] = None,
    stride: int = 1,
    dt_ps: Optional[float] = None,
    source_range: Optional[Sequence[int]] = None,
    bias: Optional[Dict] = None,
    index: Optional[int] = None,
    exchange_history: Optional[np.ndarray] = None,
    extra_metadata: Optional[Dict] = None,
) -> Path:
    """Write one shard (npz + json). Returns the npz path.

    ``features`` (T, K) float32 and/or ``coordinates`` (T, N, 3) float32.
    ``source_range`` is the [start, stop) frame span in the producing
    trajectory (reference CHANGELOG.md:103-104).
    """
    if features is None and coordinates is None:
        raise ValueError("shard must contain features and/or coordinates")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    sid = shard_id(temperature_K, run_id, index)
    arrays: Dict[str, np.ndarray] = {}
    n_frames = None
    if features is not None:
        arrays["features"] = np.asarray(features, dtype=np.float32)
        n_frames = arrays["features"].shape[0]
    if coordinates is not None:
        arrays["coordinates"] = np.asarray(coordinates, dtype=np.float32)
        if n_frames is not None and arrays["coordinates"].shape[0] != n_frames:
            raise ValueError(
                f"features have {n_frames} frames but coordinates "
                f"{arrays['coordinates'].shape[0]} — a shard's arrays must "
                "describe the same frames (n_frames metadata would lie)"
            )
        n_frames = arrays["coordinates"].shape[0]
    if exchange_history is not None:
        arrays["exchange_history"] = np.asarray(exchange_history)

    meta = {
        "schema_version": SCHEMA_VERSION,
        "shard_id": sid,
        "temperature_K": float(temperature_K),
        "run_id": str(run_id),
        "n_frames": int(n_frames),
        "stride": int(stride),
        "dt_ps": float(dt_ps) if dt_ps is not None else None,
        "source": {
            "range": [int(x) for x in source_range] if source_range is not None else None,
        },
        "feature_spec": list(feature_spec) if feature_spec is not None else None,
        "feature_spec_hash": feature_spec_hash(feature_spec) if feature_spec else None,
        "bias": sanitize_for_json(bias) if bias else None,
    }
    if extra_metadata:
        meta.update(sanitize_for_json(extra_metadata))

    npz_path = directory / f"{sid}.npz"
    json_path = directory / f"{sid}.json"
    tmp = npz_path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, **arrays)
    tmp.replace(npz_path)
    json_path.write_text(json.dumps(meta, indent=2))
    return npz_path


def read_shard(path: "str | Path") -> Dict:
    """Load a shard into {'metadata': ..., 'features': ..., 'coordinates': ...}."""
    path = Path(path)
    if path.suffix == ".json":
        path = path.with_suffix(".npz")
    json_path = path.with_suffix(".json")
    if not json_path.exists():
        raise FileNotFoundError(f"shard metadata missing: {json_path}")
    meta = json.loads(json_path.read_text())
    out: Dict = {"metadata": meta}
    with np.load(path) as data:
        for key in data.files:
            out[key] = np.asarray(data[key])
    return out


def select_shard_paths(
    directory: "str | Path",
    *,
    temperature_K: Optional[float] = None,
    run_id: Optional[str] = None,
    limit: Optional[int] = None,
) -> List[Path]:
    """Deterministically ordered shard selection
    (reference CHANGELOG.md:52-57 select_shard_paths)."""
    directory = Path(directory)
    paths = sorted(directory.glob("T*_run-*.npz"))
    out = []
    for p in paths:
        meta_path = p.with_suffix(".json")
        if not meta_path.exists():
            continue
        meta = json.loads(meta_path.read_text())
        if temperature_K is not None and not np.isclose(
            meta.get("temperature_K"), temperature_K
        ):
            continue
        if run_id is not None and meta.get("run_id") != run_id:
            continue
        out.append(p)
        if limit is not None and len(out) >= limit:
            break
    return out


def emit_shards_from_trajectory(
    directory: "str | Path",
    features: np.ndarray,
    *,
    temperature_K: float,
    run_id: str,
    frames_per_shard: int,
    stride: int = 1,
    dt_ps: Optional[float] = None,
    feature_spec: Optional[Sequence[str]] = None,
    bias: Optional[Dict] = None,
) -> List[Path]:
    """Split one featurized trajectory into fixed-size shards
    (reference CHANGELOG.md:247 emit_shards_from_trajectories)."""
    features = np.asarray(features)
    paths = []
    n = features.shape[0]
    for i, start in enumerate(range(0, n, frames_per_shard)):
        stop = min(start + frames_per_shard, n)
        if stop - start < 2:
            continue  # a shard with <2 frames carries no transitions
        paths.append(
            write_shard(
                directory,
                temperature_K=temperature_K,
                run_id=run_id,
                features=features[start:stop],
                feature_spec=feature_spec,
                stride=stride,
                dt_ps=dt_ps,
                source_range=(start, stop),
                bias=bias,
                index=i,
            )
        )
    return paths


__all__ = [
    "shard_id",
    "feature_spec_hash",
    "write_shard",
    "read_shard",
    "select_shard_paths",
    "emit_shards_from_trajectory",
]
