"""Model bundle export (reference: src/pmarlo/io/export.py:14
export_deeptica_bundle — model + scaler + config + history).

Host copy of ``pmarlo_tpu/io/export.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

from ..ml.deeptica import DeepTICAModel
from ..utils.json_io import write_json


def export_deeptica_bundle(
    model: DeepTICAModel,
    directory: "str | Path",
    *,
    name: str = "deeptica",
    extra_metadata: Optional[Dict] = None,
) -> Path:
    """Write a self-contained CV bundle: weights npz + config json +
    history json + bundle manifest. Unlike the reference there is no
    TorchScript artifact — the weights npz plus ``DeepTICAModel.load`` fully
    reconstruct the jittable CV function."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    prefix = directory / name
    model.save(prefix)
    manifest = {
        "format": "pmarlo_tpu.deeptica_bundle.v1",
        "files": {
            "config": f"{name}.json",
            "weights": f"{name}.weights.npz",
            "history": f"{name}.history.json" if model.training_history else None,
        },
        "n_out": model.config.n_out,
        "lag": model.config.lag,
        "whitened": model.whitening is not None,
    }
    if extra_metadata:
        manifest["metadata"] = extra_metadata
    write_json(directory / f"{name}.bundle.json", manifest)
    return directory


def load_deeptica_bundle(directory: "str | Path", name: str = "deeptica") -> DeepTICAModel:
    return DeepTICAModel.load(Path(directory) / name)


__all__ = ["export_deeptica_bundle", "load_deeptica_bundle"]
