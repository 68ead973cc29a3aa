"""Thermodynamic helpers (reference: src/pmarlo/utils/thermodynamics.py:9).

Host copy of ``pmarlo_tpu/utils/thermodynamics.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL


def kT_kJ_per_mol(temperature_K: float) -> float:
    """k_B * T in kJ/mol."""
    if temperature_K <= 0:
        raise ValueError(f"temperature must be positive, got {temperature_K}")
    return BOLTZMANN_CONSTANT_KJ_PER_MOL * float(temperature_K)


def beta_per_kJ_mol(temperature_K: float) -> float:
    """1/(k_B T) in mol/kJ."""
    return 1.0 / kT_kJ_per_mol(temperature_K)
