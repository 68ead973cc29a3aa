"""Typed exceptions — the framework fails fast, never falls back silently.

(Reference pattern: src/pmarlo/utils/errors.py:6 and the "no silent
fallbacks" policy, README.md:119-121.)

Host copy of ``pmarlo_tpu/utils/errors.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations


class PmarloError(Exception):
    """Base class for all framework errors."""


class TemperatureConsistencyError(PmarloError):
    """Raised when shard temperatures disagree with the requested analysis."""


class WhiteningError(PmarloError):
    """Raised when CV whitening metadata is missing or inconsistent."""


class TopologyError(PmarloError):
    """Raised when a structure cannot be matched to force-field templates."""


class ForceFieldError(PmarloError):
    """Raised when force-field parameters are missing for a system."""


class EstimationError(PmarloError):
    """Raised when an MSM/TICA/FES estimate cannot be produced."""


class NoAssignmentsError(EstimationError):
    """Raised when discretization produced no usable state assignments
    (reference: analysis/discretize.py:46)."""
