"""GBn2 (GB-neck2, igb=8) constants of Nguyen, Roe & Simmerling 2013 (J.
Chem. Theory Comput. 9, 2020), as OpenMM's ``implicit/gbn2.xml`` and
Amber's igb=8 give them: the dielectric offset (nm), the neck's scale, the
per-element alpha / beta / gamma and screening. Frozen as written in
``pmarlo_tpu_torch/md/gbn2.py`` at commit be358b3; the neck's d0 / m0 are
not copied but worked out in ``reference/neck.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple


GBN2_OFFSET = 0.0195141
GBN2_NECK_SCALE = 0.826836
GBN2_ALPHA_BETA_GAMMA: Dict[str, Tuple[float, float, float]] = {
    "H": (0.788440, 0.798699, 0.437334),
    "C": (0.733756, 0.506378, 0.205844),
    "N": (0.503364, 0.316828, 0.192915),
    "O": (0.867814, 0.876635, 0.387882),
    "S": (0.867814, 0.876635, 0.387882),
}
GBN2_ABG_DEFAULT = (1.0, 0.8, 4.851)
GBN2_SCREEN: Dict[str, float] = {
    "H": 1.425952,
    "C": 1.058554,
    "N": 0.733599,
    "O": 1.061039,
    "S": -0.703469,
    "P": 0.500000,
}
GBN2_SCREEN_DEFAULT = 0.5
