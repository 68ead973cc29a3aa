"""
Host copy of ``pmarlo_tpu/settings/__init__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""
from .loader import (
    ENV_CONFIG_FILE,
    REQUIRED_CONFIG_KEYS,
    load_defaults,
    load_feature_spec,
)

__all__ = [
    "load_defaults",
    "load_feature_spec",
    "REQUIRED_CONFIG_KEYS",
    "ENV_CONFIG_FILE",
]
