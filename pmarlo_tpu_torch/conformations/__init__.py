"""TPT conformation discovery: sources/sinks, flux, importance, uncertainty.

Rebuild of src/pmarlo/conformations/: find_conformations (finder.py:222),
TPTAnalysis (tpt_analysis.py:34), StateDetector (state_detection.py:13),
KineticImportanceScore (kinetic_importance.py:17), UncertaintyQuantifier
(uncertainty.py:15), RepresentativePicker (representative_picker.py:112),
result dataclasses (results.py).

Host copy of ``pmarlo_tpu/conformations/__init__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from .finder import find_conformations
from .results import Conformation, ConformationSet, KISResult, UncertaintyResult
from .state_detection import StateDetector
from .kinetic_importance import KineticImportanceScore
from .uncertainty import UncertaintyQuantifier
from .representative_picker import RepresentativePicker, FrameIndexLookup

__all__ = [
    "find_conformations",
    "Conformation",
    "ConformationSet",
    "KISResult",
    "UncertaintyResult",
    "StateDetector",
    "KineticImportanceScore",
    "UncertaintyQuantifier",
    "RepresentativePicker",
    "FrameIndexLookup",
]
