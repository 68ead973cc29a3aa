"""Frozen copy of ``pmarlo_tpu_torch/md/residues.py`` (pmarlo_tpu_torch at commit be358b3), kept
unchanged under the benchmark as part of its yardstick: the reference
derives its parameters with it and imports nothing of the measured package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

ResidueTemplate = Dict[str, object]


def _t(atoms, bonds, head="N", tail="C") -> ResidueTemplate:
    return {"atoms": atoms, "bonds": bonds, "head": head, "tail": tail}


TEMPLATES: Dict[str, ResidueTemplate] = {}

# --- capping groups ---------------------------------------------------------

TEMPLATES["ACE"] = _t(
    atoms={
        "HH31": ("HC", 0.1123), "CH3": ("CT", -0.3662), "HH32": ("HC", 0.1123),
        "HH33": ("HC", 0.1123), "C": ("C", 0.5972), "O": ("O", -0.5679),
    },
    bonds=[("CH3", "HH31"), ("CH3", "HH32"), ("CH3", "HH33"),
           ("CH3", "C"), ("C", "O")],
    head=None,
    tail="C",
)

TEMPLATES["NME"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CH3": ("CT", -0.1490),
        "HH31": ("H1", 0.0976), "HH32": ("H1", 0.0976), "HH33": ("H1", 0.0976),
    },
    bonds=[("N", "H"), ("N", "CH3"), ("CH3", "HH31"), ("CH3", "HH32"),
           ("CH3", "HH33")],
    head="N",
    tail=None,
)

# --- standard residues ------------------------------------------------------

_BACKBONE_BONDS = [("N", "H"), ("N", "CA"), ("CA", "HA"), ("CA", "C"), ("C", "O")]

TEMPLATES["ALA"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", 0.0337),
        "HA": ("H1", 0.0823), "CB": ("CT", -0.1825),
        "HB1": ("HC", 0.0603), "HB2": ("HC", 0.0603), "HB3": ("HC", 0.0603),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB1"), ("CB", "HB2"),
                             ("CB", "HB3")],
)

TEMPLATES["GLY"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0252),
        "HA2": ("H1", 0.0698), "HA3": ("H1", 0.0698),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=[("N", "H"), ("N", "CA"), ("CA", "HA2"), ("CA", "HA3"),
           ("CA", "C"), ("C", "O")],
)

TEMPLATES["ASP"] = _t(
    atoms={
        "N": ("N", -0.5163), "H": ("H", 0.2936), "CA": ("CT", 0.0381),
        "HA": ("H1", 0.0880), "CB": ("CT", -0.0303),
        "HB2": ("HC", -0.0122), "HB3": ("HC", -0.0122),
        "CG": ("C", 0.7994), "OD1": ("O2", -0.8014), "OD2": ("O2", -0.8014),
        "C": ("C", 0.5366), "O": ("O", -0.5819),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "OD1"), ("CG", "OD2")],
)

TEMPLATES["GLU"] = _t(
    atoms={
        "N": ("N", -0.5163), "H": ("H", 0.2936), "CA": ("CT", 0.0397),
        "HA": ("H1", 0.1105), "CB": ("CT", 0.0560),
        "HB2": ("HC", -0.0173), "HB3": ("HC", -0.0173),
        "CG": ("CT", 0.0136), "HG2": ("HC", -0.0425), "HG3": ("HC", -0.0425),
        "CD": ("C", 0.8054), "OE1": ("O2", -0.8188), "OE2": ("O2", -0.8188),
        "C": ("C", 0.5366), "O": ("O", -0.5819),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "HG2"), ("CG", "HG3"),
                             ("CG", "CD"), ("CD", "OE1"), ("CD", "OE2")],
)

TEMPLATES["THR"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0389),
        "HA": ("H1", 0.1007), "CB": ("CT", 0.3654), "HB": ("H1", 0.0043),
        "OG1": ("OH", -0.6761), "HG1": ("HO", 0.4102),
        "CG2": ("CT", -0.2438),
        "HG21": ("HC", 0.0642), "HG22": ("HC", 0.0642), "HG23": ("HC", 0.0642),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB"), ("CB", "OG1"),
                             ("OG1", "HG1"), ("CB", "CG2"), ("CG2", "HG21"),
                             ("CG2", "HG22"), ("CG2", "HG23")],
)

TEMPLATES["TYR"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0014),
        "HA": ("H1", 0.0876), "CB": ("CT", -0.0152),
        "HB2": ("HC", 0.0295), "HB3": ("HC", 0.0295),
        "CG": ("CA", -0.0011),
        "CD1": ("CA", -0.1906), "HD1": ("HA", 0.1699),
        "CD2": ("CA", -0.1906), "HD2": ("HA", 0.1699),
        "CE1": ("CA", -0.2341), "HE1": ("HA", 0.1656),
        "CE2": ("CA", -0.2341), "HE2": ("HA", 0.1656),
        # Amber types TYR CZ as carbonyl-like "C"; we keep aromatic CA so the
        # ring uses one consistent parameter family (documented deviation).
        "CZ": ("CA", 0.3226), "OH": ("OH", -0.5579), "HH": ("HO", 0.3992),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
                             ("CD1", "HD1"), ("CD2", "HD2"),
                             ("CD1", "CE1"), ("CD2", "CE2"),
                             ("CE1", "HE1"), ("CE2", "HE2"),
                             ("CE1", "CZ"), ("CE2", "CZ"),
                             ("CZ", "OH"), ("OH", "HH")],
)

TEMPLATES["TRP"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0275),
        "HA": ("H1", 0.1123), "CB": ("CT", -0.0050),
        "HB2": ("HC", 0.0339), "HB3": ("HC", 0.0339),
        "CG": ("C*", -0.1415),
        "CD1": ("CW", -0.1638), "HD1": ("H4", 0.2062),
        "NE1": ("NA", -0.3418), "HE1": ("H", 0.3412),
        "CE2": ("CN", 0.1380), "CD2": ("CB", 0.1243),
        "CE3": ("CA", -0.2387), "HE3": ("HA", 0.1700),
        "CZ2": ("CA", -0.2601), "HZ2": ("HA", 0.1572),
        "CZ3": ("CA", -0.1972), "HZ3": ("HA", 0.1447),
        "CH2": ("CA", -0.1134), "HH2": ("HA", 0.1417),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
                             ("CD1", "HD1"), ("CD1", "NE1"), ("NE1", "HE1"),
                             ("NE1", "CE2"), ("CE2", "CD2"),
                             ("CD2", "CE3"), ("CE3", "HE3"),
                             ("CE3", "CZ3"), ("CZ3", "HZ3"),
                             ("CZ3", "CH2"), ("CH2", "HH2"),
                             ("CH2", "CZ2"), ("CZ2", "HZ2"),
                             ("CZ2", "CE2")],
)

TEMPLATES["PRO"] = _t(
    atoms={
        "N": ("N", -0.2548),
        "CD": ("CT", 0.0192), "HD2": ("H1", 0.0391), "HD3": ("H1", 0.0391),
        "CG": ("CT", 0.0189), "HG2": ("HC", 0.0213), "HG3": ("HC", 0.0213),
        "CB": ("CT", -0.0070), "HB2": ("HC", 0.0253), "HB3": ("HC", 0.0253),
        "CA": ("CT", -0.0266), "HA": ("H1", 0.0641),
        "C": ("C", 0.5896), "O": ("O", -0.5748),
    },
    bonds=[("N", "CA"), ("N", "CD"), ("CA", "HA"), ("CA", "C"), ("C", "O"),
           ("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"), ("CB", "CG"),
           ("CG", "HG2"), ("CG", "HG3"), ("CG", "CD"), ("CD", "HD2"),
           ("CD", "HD3")],
)

TEMPLATES["SER"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0249),
        "HA": ("H1", 0.0843), "CB": ("CT", 0.2117),
        "HB2": ("H1", 0.0352), "HB3": ("H1", 0.0352),
        "OG": ("OH", -0.6546), "HG": ("HO", 0.4275),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "OG"), ("OG", "HG")],
)

TEMPLATES["CYS"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", 0.0213),
        "HA": ("H1", 0.1124), "CB": ("CT", -0.1231),
        "HB2": ("H1", 0.1112), "HB3": ("H1", 0.1112),
        "SG": ("SH", -0.3119), "HG": ("HS", 0.1933),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "SG"), ("SG", "HG")],
)

TEMPLATES["CYX"] = _t(  # disulfide-bonded cystine half
    # Derived from CYS by removing HG and folding its charge onto SG
    # (total stays exactly 0) — a documented charge-conserving
    # approximation of the amber CYX set; the S-S bond is added at
    # topology-build time when two SG atoms sit within 2.5 A.
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", 0.0213),
        "HA": ("H1", 0.1124), "CB": ("CT", -0.1231),
        "HB2": ("H1", 0.1112), "HB3": ("H1", 0.1112),
        "SG": ("S", -0.1186),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "SG")],
)

TEMPLATES["MET"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0237),
        "HA": ("H1", 0.0880), "CB": ("CT", 0.0342),
        "HB2": ("HC", 0.0241), "HB3": ("HC", 0.0241),
        "CG": ("CT", 0.0018), "HG2": ("H1", 0.0440), "HG3": ("H1", 0.0440),
        "SD": ("S", -0.2737), "CE": ("CT", -0.0536),
        "HE1": ("H1", 0.0684), "HE2": ("H1", 0.0684), "HE3": ("H1", 0.0684),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "HG2"), ("CG", "HG3"),
                             ("CG", "SD"), ("SD", "CE"), ("CE", "HE1"),
                             ("CE", "HE2"), ("CE", "HE3")],
)

TEMPLATES["VAL"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0875),
        "HA": ("H1", 0.0969), "CB": ("CT", 0.2985), "HB": ("HC", -0.0297),
        "CG1": ("CT", -0.3192),
        "HG11": ("HC", 0.0791), "HG12": ("HC", 0.0791), "HG13": ("HC", 0.0791),
        "CG2": ("CT", -0.3192),
        "HG21": ("HC", 0.0791), "HG22": ("HC", 0.0791), "HG23": ("HC", 0.0791),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB"),
                             ("CB", "CG1"), ("CG1", "HG11"), ("CG1", "HG12"),
                             ("CG1", "HG13"), ("CB", "CG2"), ("CG2", "HG21"),
                             ("CG2", "HG22"), ("CG2", "HG23")],
)

TEMPLATES["LEU"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0518),
        "HA": ("H1", 0.0922), "CB": ("CT", -0.1102),
        "HB2": ("HC", 0.0457), "HB3": ("HC", 0.0457),
        "CG": ("CT", 0.3531), "HG": ("HC", -0.0361),
        "CD1": ("CT", -0.4121),
        "HD11": ("HC", 0.1000), "HD12": ("HC", 0.1000), "HD13": ("HC", 0.1000),
        "CD2": ("CT", -0.4121),
        "HD21": ("HC", 0.1000), "HD22": ("HC", 0.1000), "HD23": ("HC", 0.1000),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "HG"),
                             ("CG", "CD1"), ("CD1", "HD11"), ("CD1", "HD12"),
                             ("CD1", "HD13"), ("CG", "CD2"), ("CD2", "HD21"),
                             ("CD2", "HD22"), ("CD2", "HD23")],
)

TEMPLATES["ILE"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0597),
        "HA": ("H1", 0.0869), "CB": ("CT", 0.1303), "HB": ("HC", 0.0187),
        "CG2": ("CT", -0.3204),
        "HG21": ("HC", 0.0882), "HG22": ("HC", 0.0882), "HG23": ("HC", 0.0882),
        "CG1": ("CT", -0.0430),
        "HG12": ("HC", 0.0236), "HG13": ("HC", 0.0236),
        "CD1": ("CT", -0.0660),
        "HD11": ("HC", 0.0186), "HD12": ("HC", 0.0186), "HD13": ("HC", 0.0186),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB"),
                             ("CB", "CG2"), ("CG2", "HG21"), ("CG2", "HG22"),
                             ("CG2", "HG23"), ("CB", "CG1"), ("CG1", "HG12"),
                             ("CG1", "HG13"), ("CG1", "CD1"), ("CD1", "HD11"),
                             ("CD1", "HD12"), ("CD1", "HD13")],
)

TEMPLATES["PHE"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0024),
        "HA": ("H1", 0.0978), "CB": ("CT", -0.0343),
        "HB2": ("HC", 0.0295), "HB3": ("HC", 0.0295),
        "CG": ("CA", 0.0118),
        "CD1": ("CA", -0.1256), "HD1": ("HA", 0.1330),
        "CD2": ("CA", -0.1256), "HD2": ("HA", 0.1330),
        "CE1": ("CA", -0.1704), "HE1": ("HA", 0.1430),
        "CE2": ("CA", -0.1704), "HE2": ("HA", 0.1430),
        "CZ": ("CA", -0.1072), "HZ": ("HA", 0.1297),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
                             ("CD1", "HD1"), ("CD2", "HD2"),
                             ("CD1", "CE1"), ("CD2", "CE2"),
                             ("CE1", "HE1"), ("CE2", "HE2"),
                             ("CE1", "CZ"), ("CE2", "CZ"), ("CZ", "HZ")],
)

TEMPLATES["ASN"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", 0.0143),
        "HA": ("H1", 0.1048), "CB": ("CT", -0.2041),
        "HB2": ("HC", 0.0797), "HB3": ("HC", 0.0797),
        "CG": ("C", 0.7130), "OD1": ("O", -0.5931),
        "ND2": ("N", -0.9191), "HD21": ("H", 0.4196), "HD22": ("H", 0.4196),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "OD1"), ("CG", "ND2"),
                             ("ND2", "HD21"), ("ND2", "HD22")],
)

TEMPLATES["GLN"] = _t(
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0031),
        "HA": ("H1", 0.0850), "CB": ("CT", -0.0036),
        "HB2": ("HC", 0.0171), "HB3": ("HC", 0.0171),
        "CG": ("CT", -0.0645), "HG2": ("HC", 0.0352), "HG3": ("HC", 0.0352),
        "CD": ("C", 0.6951), "OE1": ("O", -0.6086),
        "NE2": ("N", -0.9407), "HE21": ("H", 0.4251), "HE22": ("H", 0.4251),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "HG2"), ("CG", "HG3"),
                             ("CG", "CD"), ("CD", "OE1"), ("CD", "NE2"),
                             ("NE2", "HE21"), ("NE2", "HE22")],
)

TEMPLATES["LYS"] = _t(
    atoms={
        "N": ("N", -0.3479), "H": ("H", 0.2747), "CA": ("CT", -0.2400),
        "HA": ("H1", 0.1426), "CB": ("CT", -0.0094),
        "HB2": ("HC", 0.0362), "HB3": ("HC", 0.0362),
        "CG": ("CT", 0.0187), "HG2": ("HC", 0.0103), "HG3": ("HC", 0.0103),
        "CD": ("CT", -0.0479), "HD2": ("HC", 0.0621), "HD3": ("HC", 0.0621),
        "CE": ("CT", -0.0143), "HE2": ("HP", 0.1135), "HE3": ("HP", 0.1135),
        "NZ": ("N3", -0.3854),
        "HZ1": ("H", 0.3400), "HZ2": ("H", 0.3400), "HZ3": ("H", 0.3400),
        "C": ("C", 0.7341), "O": ("O", -0.5894),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "HG2"), ("CG", "HG3"),
                             ("CG", "CD"), ("CD", "HD2"), ("CD", "HD3"),
                             ("CD", "CE"), ("CE", "HE2"), ("CE", "HE3"),
                             ("CE", "NZ"), ("NZ", "HZ1"), ("NZ", "HZ2"),
                             ("NZ", "HZ3")],
)

TEMPLATES["ARG"] = _t(
    atoms={
        "N": ("N", -0.3479), "H": ("H", 0.2747), "CA": ("CT", -0.2637),
        "HA": ("H1", 0.1560), "CB": ("CT", -0.0007),
        "HB2": ("HC", 0.0327), "HB3": ("HC", 0.0327),
        "CG": ("CT", 0.0390), "HG2": ("HC", 0.0285), "HG3": ("HC", 0.0285),
        "CD": ("CT", 0.0486), "HD2": ("H1", 0.0687), "HD3": ("H1", 0.0687),
        "NE": ("N2", -0.5295), "HE": ("H", 0.3456),
        "CZ": ("CA", 0.8076),
        "NH1": ("N2", -0.8627), "HH11": ("H", 0.4478), "HH12": ("H", 0.4478),
        "NH2": ("N2", -0.8627), "HH21": ("H", 0.4478), "HH22": ("H", 0.4478),
        "C": ("C", 0.7341), "O": ("O", -0.5894),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "HG2"), ("CG", "HG3"),
                             ("CG", "CD"), ("CD", "HD2"), ("CD", "HD3"),
                             ("CD", "NE"), ("NE", "HE"), ("NE", "CZ"),
                             ("CZ", "NH1"), ("NH1", "HH11"), ("NH1", "HH12"),
                             ("CZ", "NH2"), ("NH2", "HH21"), ("NH2", "HH22")],
)

# --- protonation variants (amber all_amino94.lib family) --------------------
# Charges transcribed from the published amber tables; every set closes to
# its integer total charge exactly (regression-tested in
# tests/unit/test_protein_hydrogens.py::test_variant_charge_closure).

TEMPLATES["ASH"] = _t(  # protonated ASP (neutral), pH < pKa
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", 0.0341),
        "HA": ("H1", 0.0864), "CB": ("CT", -0.0316),
        "HB2": ("HC", 0.0488), "HB3": ("HC", 0.0488),
        "CG": ("C", 0.6462), "OD1": ("O", -0.5554),
        "OD2": ("OH", -0.6376), "HD2": ("HO", 0.4747),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "OD1"), ("CG", "OD2"),
                             ("OD2", "HD2")],
)

TEMPLATES["GLH"] = _t(  # protonated GLU (neutral)
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", 0.0145),
        "HA": ("H1", 0.0779), "CB": ("CT", -0.0071),
        "HB2": ("HC", 0.0256), "HB3": ("HC", 0.0256),
        "CG": ("CT", -0.0174), "HG2": ("HC", 0.0430), "HG3": ("HC", 0.0430),
        "CD": ("C", 0.6801), "OE1": ("O", -0.5838),
        "OE2": ("OH", -0.6511), "HE2": ("HO", 0.4641),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "HG2"), ("CG", "HG3"),
                             ("CG", "CD"), ("CD", "OE1"), ("CD", "OE2"),
                             ("OE2", "HE2")],
)

TEMPLATES["LYN"] = _t(  # neutral LYS, pH > pKa
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.07206),
        "HA": ("H1", 0.0994), "CB": ("CT", -0.04845),
        "HB2": ("HC", 0.0340), "HB3": ("HC", 0.0340),
        "CG": ("CT", 0.06612), "HG2": ("HC", 0.01041), "HG3": ("HC", 0.01041),
        "CD": ("CT", -0.03768), "HD2": ("HC", 0.01155), "HD3": ("HC", 0.01155),
        "CE": ("CT", 0.32604), "HE2": ("HP", -0.03358), "HE3": ("HP", -0.03358),
        "NZ": ("N3", -1.03581), "HZ2": ("H", 0.38604), "HZ3": ("H", 0.38604),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"),
                             ("CB", "CG"), ("CG", "HG2"), ("CG", "HG3"),
                             ("CG", "CD"), ("CD", "HD2"), ("CD", "HD3"),
                             ("CD", "CE"), ("CE", "HE2"), ("CE", "HE3"),
                             ("CE", "NZ"), ("NZ", "HZ2"), ("NZ", "HZ3")],
)

# Histidine: neutral epsilon tautomer (HIE), the amber default for "HIS"
_HIS_ATOMS = {
    "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", -0.0581),
    "HA": ("H1", 0.1360), "CB": ("CT", -0.0074),
    "HB2": ("HC", 0.0367), "HB3": ("HC", 0.0367),
    "CG": ("CC", 0.1868), "ND1": ("NB", -0.5432),
    "CE1": ("CR", 0.1635), "HE1": ("H5", 0.1435),
    "NE2": ("NA", -0.2795), "HE2": ("H", 0.3339),
    "CD2": ("CW", -0.2207), "HD2": ("H4", 0.1862),
    "C": ("C", 0.5973), "O": ("O", -0.5679),
}
_HIS_BONDS = _BACKBONE_BONDS + [
    ("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"), ("CB", "CG"),
    ("CG", "ND1"), ("ND1", "CE1"), ("CE1", "HE1"), ("CE1", "NE2"),
    ("NE2", "HE2"), ("NE2", "CD2"), ("CD2", "HD2"), ("CD2", "CG"),
]
TEMPLATES["HIS"] = _t(atoms=_HIS_ATOMS, bonds=_HIS_BONDS)
TEMPLATES["HIE"] = TEMPLATES["HIS"]

TEMPLATES["HID"] = _t(  # neutral delta tautomer
    atoms={
        "N": ("N", -0.4157), "H": ("H", 0.2719), "CA": ("CT", 0.0188),
        "HA": ("H1", 0.0881), "CB": ("CT", -0.0462),
        "HB2": ("HC", 0.0402), "HB3": ("HC", 0.0402),
        "CG": ("CC", -0.0266), "ND1": ("NA", -0.3811), "HD1": ("H", 0.3649),
        "CE1": ("CR", 0.2057), "HE1": ("H5", 0.1392),
        "NE2": ("NB", -0.5727),
        "CD2": ("CV", 0.1292), "HD2": ("H4", 0.1147),
        "C": ("C", 0.5973), "O": ("O", -0.5679),
    },
    bonds=_BACKBONE_BONDS + [
        ("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"), ("CB", "CG"),
        ("CG", "ND1"), ("ND1", "HD1"), ("ND1", "CE1"), ("CE1", "HE1"),
        ("CE1", "NE2"), ("NE2", "CD2"), ("CD2", "HD2"), ("CD2", "CG"),
    ],
)

TEMPLATES["HIP"] = _t(  # doubly-protonated (+1), pH < ~6
    atoms={
        "N": ("N", -0.3479), "H": ("H", 0.2747), "CA": ("CT", -0.1354),
        "HA": ("H1", 0.1212), "CB": ("CT", -0.0414),
        "HB2": ("HC", 0.0810), "HB3": ("HC", 0.0810),
        "CG": ("CC", -0.0012), "ND1": ("NA", -0.1513), "HD1": ("H", 0.3866),
        "CE1": ("CR", -0.0170), "HE1": ("H5", 0.2681),
        "NE2": ("NA", -0.1718), "HE2": ("H", 0.3911),
        "CD2": ("CW", -0.1141), "HD2": ("H4", 0.2317),
        "C": ("C", 0.7341), "O": ("O", -0.5894),
    },
    bonds=_BACKBONE_BONDS + [
        ("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"), ("CB", "CG"),
        ("CG", "ND1"), ("ND1", "HD1"), ("ND1", "CE1"), ("CE1", "HE1"),
        ("CE1", "NE2"), ("NE2", "HE2"), ("NE2", "CD2"), ("CD2", "HD2"),
        ("CD2", "CG"),
    ],
)

# --- terminal variants ------------------------------------------------------
# Protonated N-terminus (NH3+) and deprotonated C-terminus (COO-). Charges
# from the amber N*/C* libraries for GLY; other residues get generated
# variants via make_terminal_variant().

TEMPLATES["NGLY"] = _t(
    atoms={
        "N": ("N3", 0.2943), "H1": ("H", 0.1642), "H2": ("H", 0.1642),
        "H3": ("H", 0.1642), "CA": ("CT", -0.0100),
        "HA2": ("HP", 0.0895), "HA3": ("HP", 0.0895),
        "C": ("C", 0.6163), "O": ("O", -0.5722),
    },
    bonds=[("N", "H1"), ("N", "H2"), ("N", "H3"), ("N", "CA"),
           ("CA", "HA2"), ("CA", "HA3"), ("CA", "C"), ("C", "O")],
    head=None,
)

TEMPLATES["NPRO"] = _t(
    # N-terminal proline: the ring nitrogen is secondary, so the charged
    # terminus is NH2+ (H2/H3 only — CD takes the third substituent
    # slot). Charges are the amber aminont library NPRO set (sums to
    # exactly +1), closing the reference parity hole: PDBFixer handles
    # PRO-initial chains (reference protein/protein.py:334-373) and this
    # raised NotImplementedError through round 3.
    atoms={
        "N": ("N3", -0.2020), "H2": ("H", 0.3120), "H3": ("H", 0.3120),
        "CD": ("CT", -0.0120), "HD2": ("HP", 0.1000), "HD3": ("HP", 0.1000),
        "CG": ("CT", -0.1210), "HG2": ("HC", 0.1000), "HG3": ("HC", 0.1000),
        "CB": ("CT", -0.1150), "HB2": ("HC", 0.1000), "HB3": ("HC", 0.1000),
        "CA": ("CT", 0.1000), "HA": ("HP", 0.1000),
        "C": ("C", 0.5260), "O": ("O", -0.5000),
    },
    bonds=[("N", "H2"), ("N", "H3"), ("N", "CA"), ("N", "CD"),
           ("CA", "HA"), ("CA", "C"), ("C", "O"),
           ("CA", "CB"), ("CB", "HB2"), ("CB", "HB3"), ("CB", "CG"),
           ("CG", "HG2"), ("CG", "HG3"), ("CG", "CD"), ("CD", "HD2"),
           ("CD", "HD3")],
    head=None,
)

TEMPLATES["CGLY"] = _t(
    atoms={
        "N": ("N", -0.3821), "H": ("H", 0.2681), "CA": ("CT", -0.2493),
        "HA2": ("H1", 0.1056), "HA3": ("H1", 0.1056),
        "C": ("C", 0.7231), "O": ("O2", -0.7855), "OXT": ("O2", -0.7855),
    },
    bonds=[("N", "H"), ("N", "CA"), ("CA", "HA2"), ("CA", "HA3"),
           ("CA", "C"), ("C", "O"), ("C", "OXT")],
    tail=None,
)


def make_terminal_variant(resname: str, kind: str) -> ResidueTemplate:
    """Derive an N- or C-terminal variant from an interior template.

    Explicit amber terminal charges are used where we have them (NGLY/CGLY);
    for other residues this applies the structural edit (NH3+ or COO-) and
    shifts the charge difference onto the backbone so the total is the
    interior total +1 (N-term) or -1 (C-term) — a documented approximation.
    """
    key = ("N" if kind == "nterm" else "C") + resname
    if key in TEMPLATES:
        return TEMPLATES[key]
    base = TEMPLATES[resname]
    atoms = dict(base["atoms"])  # type: ignore[index]
    bonds = list(base["bonds"])  # type: ignore[index]
    tmpl = {"atoms": atoms, "bonds": bonds, "head": base["head"], "tail": base["tail"]}
    if kind == "nterm":
        atoms.pop("H", None)
        bonds = [b for b in bonds if "H" not in b]
        n_type, _ = atoms["N"]
        atoms["N"] = ("N3", 0.1849)
        for h in ("H1", "H2", "H3"):
            atoms[h] = ("H", 0.1984)
            bonds.append(("N", h))
        # HA next to charged N -> HP
        for name, (t, q) in list(atoms.items()):
            if name.startswith("HA"):
                atoms[name] = ("HP", q + 0.02)
        # absorb the residual onto CA so the total is exactly interior+1
        # (otherwise every chain leaves a fractional net charge and
        # build_system rejects the system)
        interior_total = sum(
            q for (_, q) in TEMPLATES[resname]["atoms"].values()  # type: ignore[index]
        )
        current = sum(q for (_, q) in atoms.values())
        ca_type, ca_q = atoms["CA"]
        atoms["CA"] = (ca_type, ca_q + (interior_total + 1.0) - current)
        tmpl["bonds"] = bonds
        tmpl["head"] = None
    elif kind == "cterm":
        c_type, _ = atoms["C"]
        atoms["C"] = ("C", 0.7231)
        atoms["O"] = ("O2", -0.7855)
        atoms["OXT"] = ("O2", -0.7855)
        bonds.append(("C", "OXT"))
        # absorb the residual onto CA so total charge is exactly interior-1
        interior_total = sum(q for (_, q) in TEMPLATES[resname]["atoms"].values())  # type: ignore[index]
        current = sum(q for (_, q) in atoms.values())
        ca_type, ca_q = atoms["CA"]
        atoms["CA"] = (ca_type, ca_q + (interior_total - 1.0) - current)
        tmpl["bonds"] = bonds
        tmpl["tail"] = None
    else:
        raise ValueError(f"kind must be nterm|cterm, got {kind!r}")
    return tmpl


# --- name normalization -----------------------------------------------------

_NAME_ALIASES = {
    "HN": "H",
    "HT1": "H1", "HT2": "H2", "HT3": "H3",
    "OT1": "O", "OT2": "OXT", "O1": "O", "O2": "OXT",
    "HA1": "HA2",  # old GLY naming HA1/HA2 -> HA2/HA3 handled contextually
    # GROMACS/CHARMM water atom names -> TIP3P template names
    "OW": "O", "HW1": "H1", "HW2": "H2", "OH2": "O",
    # TIP4P family virtual-site atom names -> the HOH4 template's M
    "EPW": "M", "MW": "M", "EP": "M",
    # TIP5P lone-pair naming variants -> the HOH5 template's L1/L2
    "EP1": "L1", "EP2": "L2", "LP1": "L1", "LP2": "L2",
}


#: nucleic residue names (PDB v3): DNA + RNA. Kept as a literal here
#: (md/nucleic.py imports this module, so importing the tuple back would
#: be circular); test_rna.py asserts it matches nucleic.NUCLEIC_RESIDUES.
NUCLEIC_RESNAMES = frozenset({"DA", "DC", "DG", "DT", "A", "C", "G", "U"})

#: PDB v2 / legacy nucleic-acid aliases (applied after star->prime)
_NUCLEIC_ALIASES: Dict[str, str] = {
    "O1P": "OP1", "O2P": "OP2",
    "H5'1": "H5'", "H5'2": "H5''", "H2'1": "H2'", "H2'2": "H2''",
    "C5M": "C7", "C5A": "C7",
    "HO5'": "H5T", "HO3'": "H3T",
    # v2 2'-hydroxyl hydrogen: the leading digit names the POSITION
    # (O2'), not the second of a prochiral pair — must be aliased
    # before the digit-shuffle rule turns it into HO''
    "2HO'": "HO2'", "HO'2": "HO2'",
}


def normalize_atom_name(name: str, resname: "str | None" = None) -> str:
    """Map PDB v2-style names onto v3 template names ("1HB" -> "HB1";
    nucleic: "O5*" -> "O5'", "1H5'" -> "H5'", "2H5'" -> "H5''",
    "O1P" -> "OP1"). ``resname`` disambiguates aliases that collide
    between polymer families (protein "O2" is a C-terminal oxygen alias
    for OXT; nucleic O2 is a base carbonyl and stays O2)."""
    name = name.strip()
    if "*" in name or "'" in name:
        name = name.replace("*", "'")
        if name in _NUCLEIC_ALIASES:  # position-digit names (2HO')
            return _NUCLEIC_ALIASES[name]
        if name and name[0].isdigit():
            lead, rest = name[0], name[1:]
            name = rest if lead == "1" else rest + "'"
        return _NUCLEIC_ALIASES.get(name, name)
    if resname in NUCLEIC_RESNAMES:
        return _NUCLEIC_ALIASES.get(name, name)
    if name in _NUCLEIC_ALIASES:
        return _NUCLEIC_ALIASES[name]
    if name and name[0].isdigit():
        name = name[1:] + name[0]
    return _NAME_ALIASES.get(name, name)


# --- solvent and ions (explicit-solvent path) -------------------------------
# TIP3P water (Jorgensen 1983 charges; rigid in production via SHAKE) and
# Joung-Cheatham monovalent ions. head/tail None: never peptide-bonded.

TEMPLATES["HOH"] = _t(
    atoms={
        "O": ("OW", -0.834), "H1": ("HW", 0.417), "H2": ("HW", 0.417),
    },
    bonds=[("O", "H1"), ("O", "H2")],
    head=None,
    tail=None,
)
TEMPLATES["WAT"] = TEMPLATES["HOH"]
# CHARMM / GROMACS water residue names alias to the same TIP3P template
TEMPLATES["TIP3"] = TEMPLATES["HOH"]
TEMPLATES["SOL"] = TEMPLATES["HOH"]

# TIP4P-Ew 4-site water (Horn et al., J. Chem. Phys. 120, 9665 (2004)):
# O carries the LJ site, the massless M virtual site carries the charge
# on the H-H bisector. Routed automatically when a water residue carries
# an M/EPW atom (md/topology.py). The reference reaches this model via
# OpenMM's amber14/tip4pew.xml (protein/protein.py:334-373 solvation
# path); weights below are that file's canonical
# ThreeParticleAverageSite values. The O-M "bond" is zero-stiffness —
# it exists to give M the water's exclusion graph (1-2/1-3 walks).
def _tip5p_oop_weights():
    """OutOfPlaneSite weights [w12, w13, wcross] for the TIP5P lone
    pairs, solved from the rigid geometry (O-H 0.09572 nm / HOH 104.52
    deg; O-L 0.070 nm / LOL 109.47 deg, Mahoney & Jorgensen, J. Chem.
    Phys. 112, 8910 (2000)). With d12/d13 the O->H bond vectors, the
    lone pair sits at O + w(d12 + d13) +- wc (d12 x d13): the in-plane
    part points DOWN the HOH bisector (w < 0), the cross term carries
    the out-of-plane lobe."""
    import numpy as _np

    d, theta = 0.09572, _np.deg2rad(104.52)
    r_ol, phi = 0.070, _np.deg2rad(109.47)
    h1 = d * _np.array([_np.cos(theta / 2), _np.sin(theta / 2), 0.0])
    h2 = d * _np.array([_np.cos(theta / 2), -_np.sin(theta / 2), 0.0])
    target = r_ol * _np.array([-_np.cos(phi / 2), 0.0, _np.sin(phi / 2)])
    w = target[0] / (h1 + h2)[0]
    wc = target[2] / _np.cross(h1, h2)[2]
    return float(w), float(wc)


_TIP5P_W, _TIP5P_WC = _tip5p_oop_weights()

# TIP5P 5-site water (Mahoney & Jorgensen 2000): LJ on O, charges on the
# two H (+0.241) and two massless lone pairs L1/L2 (-0.241) held out of
# the HOH plane by OutOfPlaneSite constructions (md/vsites.py kind=1).
# Routed automatically when a water residue carries L1/L2 (EP1/LP1
# naming normalized below). The reference reaches multi-site waters via
# OpenMM ForceField XMLs (protein/protein.py:334-373); OpenMM's
# tip5p.xml uses the same OutOfPlaneSite semantics. Zero-stiffness O-L
# bonds give the sites the water's exclusion graph.
TEMPLATES["HOH5"] = {
    "atoms": {
        "O": ("OW5", 0.0), "H1": ("HW", 0.241), "H2": ("HW", 0.241),
        "L1": ("LW", -0.241), "L2": ("LW", -0.241),
    },
    "bonds": [("O", "H1"), ("O", "H2"), ("O", "L1"), ("O", "L2")],
    "head": None,
    "tail": None,
    "vsites": {
        "L1": ("O", "H1", "H2", _TIP5P_W, _TIP5P_W, _TIP5P_WC, "oop"),
        "L2": ("O", "H1", "H2", _TIP5P_W, _TIP5P_W, -_TIP5P_WC, "oop"),
    },
}

TEMPLATES["HOH4"] = {
    "atoms": {
        "O": ("OW4", 0.0), "H1": ("HW", 0.52422), "H2": ("HW", 0.52422),
        "M": ("MW", -1.04844),
    },
    "bonds": [("O", "H1"), ("O", "H2"), ("O", "M")],
    "head": None,
    "tail": None,
    # site -> (parent0, parent1, parent2, w0, w1, w2):
    # r_M = w0 r_O + w1 r_H1 + w2 r_H2 (0.0125 nm up the bisector)
    "vsites": {
        "M": ("O", "H1", "H2", 0.786646558, 0.106676721, 0.106676721),
    },
}

TEMPLATES["NA"] = _t(
    atoms={"NA": ("Na+", 1.0)}, bonds=[], head=None, tail=None,
)
TEMPLATES["CL"] = _t(
    atoms={"CL": ("Cl-", -1.0)}, bonds=[], head=None, tail=None,
)
# further monovalent (Joung-Cheatham) and divalent (Aqvist/Amber)
# structural ions — retained from input models (the reference's PDBFixer
# prep strips heterogens, protein/protein.py:351; keeping crystal ions
# is a deliberate capability extension for RNA/metalloprotein systems)
TEMPLATES["K"] = _t(
    atoms={"K": ("K+", 1.0)}, bonds=[], head=None, tail=None,
)
TEMPLATES["MG"] = _t(
    atoms={"MG": ("Mg2+", 2.0)}, bonds=[], head=None, tail=None,
)
TEMPLATES["ZN"] = _t(
    atoms={"ZN": ("Zn2+", 2.0)}, bonds=[], head=None, tail=None,
)
TEMPLATES["CA"] = _t(    # calcium ion (the resname namespace is
    # disjoint from atom names; no protein RESIDUE is called CA)
    atoms={"CA": ("Ca2+", 2.0)}, bonds=[], head=None, tail=None,
)

#: residues that are never part of the polypeptide chain
NONPOLYMER = {"HOH", "HOH4", "HOH5", "WAT", "TIP3", "SOL", "NA", "CL",
              "K", "MG", "ZN", "CA"}


def get_template(
    resname: str,
    is_nterm: bool = False,
    is_cterm: bool = False,
) -> ResidueTemplate:
    resname = resname.strip().upper()
    if resname not in TEMPLATES:
        raise KeyError(
            f"no residue template for {resname!r}; available: {sorted(TEMPLATES)}"
        )
    if resname in NONPOLYMER:
        return TEMPLATES[resname]
    if resname in NUCLEIC_RESNAMES:
        raise KeyError(f"the frozen copy holds no nucleic templates: {resname!r}")
    if is_nterm and TEMPLATES[resname]["head"] is not None:
        return make_terminal_variant(resname, "nterm")
    if is_cterm and TEMPLATES[resname]["tail"] is not None:
        return make_terminal_variant(resname, "cterm")
    return TEMPLATES[resname]


__all__ = [
    "TEMPLATES", "NONPOLYMER", "NUCLEIC_RESNAMES", "get_template",
    "normalize_atom_name", "make_terminal_variant",
]

