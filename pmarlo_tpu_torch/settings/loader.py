"""YAML configuration loading with required-key validation.

Reference: src/pmarlo/settings/loader.py:13-120 — required keys
{enable_cv_bias, bias_mode, torch_threads, precision}, env override
``PMARLO_CONFIG_FILE``, per-path lru_cache. ``torch_threads`` has no TPU
meaning; the equivalent resource knob here is ``device_count``.

Host copy of ``pmarlo_tpu/settings/loader.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

from ..utils.config_utils import deep_merge

REQUIRED_CONFIG_KEYS = ("enable_cv_bias", "bias_mode", "precision", "device_count")
VALID_BIAS_MODES = ("harmonic_expansion", "metadynamics", "none")
VALID_PRECISIONS = ("float32", "bfloat16")

_DEFAULTS_PATH = Path(__file__).parent / "defaults.yaml"
ENV_CONFIG_FILE = "PMARLO_CONFIG_FILE"


def _validate(config: Dict[str, Any], source: str) -> Dict[str, Any]:
    missing = [k for k in REQUIRED_CONFIG_KEYS if k not in config]
    if missing:
        raise KeyError(f"config {source} missing required keys: {missing}")
    if config["bias_mode"] not in VALID_BIAS_MODES:
        raise ValueError(
            f"bias_mode must be one of {VALID_BIAS_MODES}, got {config['bias_mode']!r}"
        )
    if config["precision"] not in VALID_PRECISIONS:
        raise ValueError(
            f"precision must be one of {VALID_PRECISIONS}, got {config['precision']!r}"
        )
    if int(config["device_count"]) < 1:
        raise ValueError("device_count must be >= 1")
    return config


@lru_cache(maxsize=32)
def _load_path(path: str) -> Dict[str, Any]:
    data = yaml.safe_load(Path(path).read_text())
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} did not parse to a mapping")
    return data


def load_defaults(config_file: Optional["str | Path"] = None) -> Dict[str, Any]:
    """Load defaults, optionally merged with an override file.

    Override resolution order: explicit argument > $PMARLO_CONFIG_FILE >
    built-in defaults only.
    """
    base = dict(_load_path(str(_DEFAULTS_PATH)))
    override = config_file or os.environ.get(ENV_CONFIG_FILE)
    if override:
        base = deep_merge(base, _load_path(str(override)))
    return _validate(base, str(override or _DEFAULTS_PATH))


_FEATURE_SPEC_PATH = Path(__file__).parent / "feature_spec.yaml"


def load_feature_spec(path: Optional["str | Path"] = None) -> Dict[str, Any]:
    """Load the canonical bias feature spec (reference settings/loader.py:146).

    Validates the minimal schema: a ``features`` list where each entry has
    a registered feature name.
    """
    data = _load_path(str(path or _FEATURE_SPEC_PATH))
    if "features" not in data or not isinstance(data["features"], list):
        raise KeyError("feature spec must contain a 'features' list")
    from ..features.base import FEATURE_REGISTRY

    for entry in data["features"]:
        name = entry.get("name") if isinstance(entry, dict) else entry
        if str(name).lower() not in FEATURE_REGISTRY:
            raise ValueError(f"feature spec names unregistered feature {name!r}")
    return data


__all__ = [
    "load_defaults",
    "load_feature_spec",
    "REQUIRED_CONFIG_KEYS",
    "ENV_CONFIG_FILE",
]
