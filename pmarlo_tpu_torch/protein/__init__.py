"""Protein preparation: the solvation box.

Port of ``pmarlo_tpu/protein``. So far it exports ``solvate_structure``
(TIP3P, TIP4P-Ew or TIP5P water around a structure, with neutralising
ions) and ``structure_formal_charge`` from ``protein/solvate.py``, a host
copy of its source; ``Protein`` and the repair and hydrogen modules are
still to be ported (ROADMAP queue A17).
"""

from .solvate import solvate_structure, structure_formal_charge

__all__ = ["solvate_structure", "structure_formal_charge"]
