"""Protein preparation: cleanup, repair, hydrogens, loops, solvation.

Port of ``pmarlo_tpu/protein``, with its exports: ``Protein``
(``protein.py``, whose ``create_system`` takes ``device=``), and from the
host copies beside it ``find_missing_heavy_atoms`` and
``repair_missing_atoms`` (``repair.py``), ``solvate_structure`` and
``structure_formal_charge`` (``solvate.py``) and ``replace_nonstandard``
(``nonstandard.py``). ``hydrogens.py``, ``loops.py`` and
``descriptors.py`` are host copies too.
"""

from .protein import Protein
from .repair import find_missing_heavy_atoms, repair_missing_atoms
from .solvate import solvate_structure, structure_formal_charge
from .nonstandard import replace_nonstandard

__all__ = [
    "Protein",
    "find_missing_heavy_atoms",
    "repair_missing_atoms",
    "solvate_structure",
    "structure_formal_charge",
    "replace_nonstandard",
]
