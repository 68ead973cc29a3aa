"""Physical constants, numeric epsilons, and framework defaults.

TPU-native rebuild of the reference constants module
(reference: src/pmarlo/constants.py:16-186). Units follow the OpenMM/MD
convention used throughout the reference: energies in kJ/mol, distances in
nm, times in ps, temperatures in K, masses in amu (g/mol).

Host copy of ``pmarlo_tpu/constants.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

# --- Physical constants ----------------------------------------------------

#: Boltzmann constant in kJ/(mol*K)  (reference constants.py:16)
BOLTZMANN_CONSTANT_KJ_PER_MOL: float = 0.00831446261815324

#: Gas constant alias (identical in molar units).
GAS_CONSTANT_KJ_PER_MOL_K: float = BOLTZMANN_CONSTANT_KJ_PER_MOL

#: Coulomb constant in kJ*nm/(mol*e^2): 1/(4*pi*eps0)
COULOMB_CONSTANT_KJ_NM_PER_MOL_E2: float = 138.93545764438198

#: Default MD timestep (ps). Reference uses 2 fs with HBond constraints +
#: HMR 1.5 amu (simulation/__init__.py:68-77). We default to 2 fs with HMR 3.
DEFAULT_TIMESTEP_PS: float = 0.002

#: Default Langevin friction (1/ps), reference simulation/__init__.py:73-77.
DEFAULT_FRICTION_PER_PS: float = 1.0

#: Default temperature (K).
DEFAULT_TEMPERATURE_K: float = 300.0

#: Hydrogen-mass-repartitioning target mass (amu).
DEFAULT_HMR_HYDROGEN_MASS: float = 3.0

# --- Numeric epsilons ------------------------------------------------------

NUMERIC_EPS: float = 1e-12
PROBABILITY_FLOOR: float = 1e-12
CHOLESKY_JITTER_INITIAL: float = 1e-6
CHOLESKY_JITTER_MAX: float = 1e-2
EIGENVALUE_FLOOR: float = 1e-10

# --- DeepTICA defaults (reference constants.py:81-121) ----------------------

DEEPTICA_DEFAULT_LAG: int = 10
DEEPTICA_DEFAULT_HIDDEN: tuple = (64, 64)
DEEPTICA_DEFAULT_N_OUT: int = 2
DEEPTICA_DEFAULT_LEARNING_RATE: float = 1e-3
DEEPTICA_DEFAULT_BATCH_SIZE: int = 1024
DEEPTICA_DEFAULT_MAX_EPOCHS: int = 200
DEEPTICA_DEFAULT_EARLY_STOPPING_PATIENCE: int = 20
DEEPTICA_DEFAULT_VAMP_RIDGE: float = 1e-4
DEEPTICA_DEFAULT_VAMP_ALPHA: float = 0.05
DEEPTICA_CONDITION_NUMBER_WARN: float = 1e6

# --- FES defaults (reference constants.py:161-186) --------------------------

FES_DEFAULT_BINS: int = 32
FES_DEFAULT_TEMPERATURE_K: float = 300.0
FES_DEFAULT_SMOOTHING_SIGMA: float = 0.6
FES_MIN_FINITE_FRACTION: float = 0.60
FES_SPARSE_WARN_FRACTION: float = 0.50

# --- MSM defaults ------------------------------------------------------------

MSM_DEFAULT_LAG: int = 10
MSM_DEFAULT_N_STATES: int = 50
MSM_DIRICHLET_PRIOR_ALPHA: float = 1e-3
ITS_DEFAULT_N_SAMPLES: int = 100

# --- REMD defaults (reference CHANGELOG.md:614) ------------------------------

REMD_DEFAULT_EXCHANGE_FREQUENCY: int = 100
REMD_DEFAULT_N_REPLICAS: int = 32
