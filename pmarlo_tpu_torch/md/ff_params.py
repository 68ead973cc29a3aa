"""AMBER-family protein force-field parameter tables (first-party).

The reference delegates parameterization to OpenMM's
``amber14-all.xml`` + ``implicit/gbn2.xml`` (src/pmarlo/simulation/
__init__.py:64-66). This module embeds a first-party parameter set with the
same functional form (harmonic bonds/angles, periodic torsions, LJ 12-6 +
Coulomb with amber 1-4 scaling, OBC-family GB implicit solvent) covering the
amino acids used by the bundled systems (alanine dipeptide, chignolin) plus
the remaining standard residue types as they get added.

Values follow the published AMBER ff94/ff99SB/ff14SB parameter family
(parm10.dat / frcmod tables); backbone torsion corrections use the ff99SB
series. They are transcribed, not copied from any file in this repo's
reference mount (which ships no force-field data).

Conventions in the *tables* (converted when building a System):
  bond:     (k_amber kcal/mol/A^2, r0 A)      E_amber = k (r - r0)^2
  angle:    (k_amber kcal/mol/rad^2, t0 deg)  E_amber = k (t - t0)^2
  dihedral: list of (divider, PK kcal/mol, phase deg, periodicity)
            E = sum PK/divider (1 + cos(n phi - phase))
  LJ:       (Rmin/2 A, eps kcal/mol)

Host copy of ``pmarlo_tpu/md/ff_params.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

KCAL_TO_KJ = 4.184

# ---------------------------------------------------------------------------
# Atom-type masses (amu)
# ---------------------------------------------------------------------------

TYPE_MASSES: Dict[str, float] = {
    "C": 12.01, "CA": 12.01, "CB": 12.01, "CC": 12.01, "CN": 12.01,
    "CR": 12.01, "CT": 12.01, "CV": 12.01, "CW": 12.01, "C*": 12.01,
    "CX": 12.01, "C8": 12.01, "2C": 12.01, "3C": 12.01, "CO": 12.01,
    "H": 1.008, "HC": 1.008, "H1": 1.008, "H2": 1.008, "H3": 1.008,
    "HA": 1.008, "H4": 1.008, "H5": 1.008, "HO": 1.008, "HS": 1.008,
    "HP": 1.008, "HW": 1.008,
    # TIP4P-Ew: LJ oxygen + massless charge site (md/vsites.py)
    "OW4": 16.00, "MW": 0.0,
    # TIP5P: LJ oxygen + two massless lone-pair sites
    "OW5": 16.00, "LW": 0.0,
    "N": 14.01, "NA": 14.01, "NB": 14.01, "N2": 14.01, "N3": 14.01,
    "O": 16.00, "O2": 16.00, "OH": 16.00, "OW": 16.00, "OS": 16.00,
    "S": 32.06, "SH": 32.06,
    # nucleic acids (parm94 base/backbone types)
    "P": 30.97, "CK": 12.01, "CM": 12.01, "CQ": 12.01,
    "NC": 14.01, "N*": 14.01,
    # monovalent ions (Joung-Cheatham TIP3P set)
    "Na+": 22.99, "Cl-": 35.45, "K+": 39.10,
    # divalent structural ions (Aqvist Mg/Ca, Amber Zn)
    "Mg2+": 24.305, "Ca2+": 40.08, "Zn2+": 65.38,
}

# Element of each atom type (for GB radii / hydrogen detection).
TYPE_ELEMENTS: Dict[str, str] = {
    t: ("H" if 0.0 < m < 2.0
        else {12.01: "C", 14.01: "N", 16.00: "O", 32.06: "S",
              30.97: "P", 22.99: "Na", 35.45: "Cl", 39.10: "K",
              24.305: "Mg", 40.08: "Ca", 65.38: "Zn", 0.0: "M"}[m])
    for t, m in TYPE_MASSES.items()
}

# ---------------------------------------------------------------------------
# Lennard-Jones (Rmin/2 in A, eps in kcal/mol) — parm10.dat NONBON section
# ---------------------------------------------------------------------------

TYPE_LJ: Dict[str, Tuple[float, float]] = {
    "C": (1.9080, 0.0860), "CA": (1.9080, 0.0860), "CB": (1.9080, 0.0860),
    "CC": (1.9080, 0.0860), "CN": (1.9080, 0.0860), "CR": (1.9080, 0.0860),
    "CV": (1.9080, 0.0860), "CW": (1.9080, 0.0860), "C*": (1.9080, 0.0860),
    "CT": (1.9080, 0.1094), "CX": (1.9080, 0.1094), "C8": (1.9080, 0.1094),
    "2C": (1.9080, 0.1094), "3C": (1.9080, 0.1094), "CO": (1.9080, 0.0860),
    "H": (0.6000, 0.0157), "HC": (1.4870, 0.0157), "H1": (1.3870, 0.0157),
    "H2": (1.2870, 0.0157), "H3": (1.1870, 0.0157), "HP": (1.1000, 0.0157),
    "HA": (1.4590, 0.0150), "H4": (1.4090, 0.0150), "H5": (1.3590, 0.0150),
    "HO": (0.0001, 0.0000), "HS": (0.6000, 0.0157),
    "N": (1.8240, 0.1700), "NA": (1.8240, 0.1700), "NB": (1.8240, 0.1700),
    "N2": (1.8240, 0.1700), "N3": (1.8240, 0.1700),
    "O": (1.6612, 0.2100), "O2": (1.6612, 0.2100), "OH": (1.7210, 0.2104),
    "OS": (1.6837, 0.1700),
    "P": (2.1000, 0.2000), "CK": (1.9080, 0.0860), "CM": (1.9080, 0.0860),
    "CQ": (1.9080, 0.0860), "NC": (1.8240, 0.1700), "N*": (1.8240, 0.1700),
    "S": (2.0000, 0.2500), "SH": (2.0000, 0.2500),
    # TIP3P water (frcmod.tip3p) and Joung-Cheatham monovalent ions
    "OW": (1.7683, 0.1520), "HW": (0.0001, 0.0000),
    # TIP4P-Ew (Horn 2004): rmin/2 1.775931 A, eps 0.16275 kcal/mol;
    # the virtual M site has no LJ
    "OW4": (1.775931, 0.16275), "MW": (0.0001, 0.0000),
    # TIP5P (Mahoney-Jorgensen 2000): sigma 3.12 A -> rmin/2
    # 3.12*2^(1/6)/2, eps 0.16 kcal/mol; lone pairs have no LJ
    "OW5": (1.751035, 0.1600), "LW": (0.0001, 0.0000),
    "Na+": (1.369, 0.0874393), "Cl-": (2.513, 0.0355910),
    "K+": (1.705, 0.1936829),
    # divalents: Aqvist (Mg2+/Ca2+, as shipped in Amber's parm) and the
    # Amber default Zn2+; adequate for structural-ion retention, not for
    # ion-binding free energies (use a dedicated multisite model there)
    "Mg2+": (0.7926, 0.8947), "Ca2+": (1.7131, 0.4598),
    "Zn2+": (1.1000, 0.0125),
}

# ---------------------------------------------------------------------------
# Bonds (k kcal/mol/A^2, r0 A) — keys are frozensets of the two types
# ---------------------------------------------------------------------------

def _b(a: str, b: str, k: float, r0: float):
    return ((a, b), (k, r0))


_BOND_LIST = [
    _b("CT", "HC", 340.0, 1.090), _b("CT", "H1", 340.0, 1.090),
    _b("CT", "HP", 340.0, 1.100), _b("CT", "CT", 310.0, 1.526),
    _b("CT", "N", 337.0, 1.449), _b("CT", "N3", 367.0, 1.471),
    _b("C", "N", 490.0, 1.335), _b("C", "O", 570.0, 1.229),
    _b("C", "O2", 656.0, 1.250), _b("C", "CT", 317.0, 1.522),
    _b("N", "H", 434.0, 1.010), _b("N3", "H", 434.0, 1.010),
    _b("N3", "HP", 434.0, 1.010),
    _b("CT", "OH", 320.0, 1.410), _b("OH", "HO", 553.0, 0.960),
    _b("CA", "CA", 469.0, 1.400), _b("CA", "HA", 367.0, 1.080),
    _b("CA", "CT", 317.0, 1.510), _b("CA", "OH", 450.0, 1.364),
    _b("C*", "CT", 317.0, 1.495), _b("C*", "CB", 388.0, 1.459),
    _b("C*", "CW", 546.0, 1.352), _b("CW", "NA", 427.0, 1.381),
    _b("CW", "H4", 367.0, 1.080), _b("NA", "H", 434.0, 1.010),
    _b("CN", "NA", 428.0, 1.380), _b("CB", "CN", 447.0, 1.419),
    _b("CA", "CB", 469.0, 1.404), _b("CA", "CN", 469.0, 1.400),
    _b("CT", "S", 227.0, 1.810), _b("CT", "SH", 237.0, 1.810),
    _b("S", "S", 166.0, 2.038), _b("SH", "HS", 274.0, 1.336),
    _b("C", "OH", 450.0, 1.364),
    # histidine / other aromatics
    _b("CC", "CT", 317.0, 1.504), _b("CC", "CV", 512.0, 1.375),
    _b("CC", "CW", 518.0, 1.371), _b("CC", "NA", 422.0, 1.385),
    _b("CC", "NB", 410.0, 1.394), _b("CV", "NB", 410.0, 1.394),
    _b("CV", "H4", 367.0, 1.080), _b("CR", "NA", 477.0, 1.343),
    _b("CR", "NB", 488.0, 1.335), _b("CR", "H5", 367.0, 1.080),
    # arginine guanidinium
    _b("CA", "N2", 481.0, 1.340), _b("N2", "H", 434.0, 1.010),
    _b("CT", "N2", 337.0, 1.463),
    # nucleic acids (parm94 nucleic section)
    _b("CT", "H2", 340.0, 1.090),
    _b("CT", "OS", 320.0, 1.410),
    _b("OS", "P", 230.0, 1.610), _b("OH", "P", 230.0, 1.610),
    _b("O2", "P", 525.0, 1.480),
    _b("CT", "N*", 337.0, 1.475),
    _b("CK", "NB", 529.0, 1.304), _b("CK", "N*", 440.0, 1.371),
    _b("CK", "H5", 367.0, 1.080),
    _b("CB", "N*", 436.0, 1.374), _b("CB", "NC", 461.0, 1.354),
    _b("CB", "NB", 414.0, 1.391),
    _b("CB", "CB", 520.0, 1.370), _b("CB", "C", 447.0, 1.419),
    _b("CA", "NC", 483.0, 1.339), _b("CQ", "NC", 502.0, 1.324),
    _b("CQ", "H5", 367.0, 1.080), _b("CA", "NA", 427.0, 1.381),
    _b("C", "NA", 418.0, 1.388), _b("C", "N*", 424.0, 1.383),
    _b("C", "NC", 457.0, 1.358),
    _b("CM", "N*", 448.0, 1.365), _b("CM", "CM", 549.0, 1.350),
    _b("CM", "CA", 427.0, 1.433), _b("CM", "C", 410.0, 1.444),
    _b("CM", "CT", 317.0, 1.510), _b("CM", "H4", 367.0, 1.080),
    _b("CM", "HA", 367.0, 1.080),
    # TIP3P water (flexible fallback; production water is SHAKE-rigid)
    _b("OW", "HW", 553.0, 0.9572),
    # TIP4P-Ew rigid geometry (bonds constrained in production; the
    # zero-k O-M entry only builds the exclusion graph for the
    # virtual site, whose position is parent-defined, md/vsites.py)
    _b("OW4", "HW", 553.0, 0.9572),
    _b("OW4", "MW", 0.0, 0.0125),
    # TIP5P rigid geometry; zero-k O-L entries only build the exclusion
    # graph for the out-of-plane lone pairs (md/vsites.py kind=1)
    _b("OW5", "HW", 553.0, 0.9572),
    _b("OW5", "LW", 0.0, 0.70),
]
BOND_PARAMS: Dict[frozenset, Tuple[float, float]] = {
    frozenset(k): v for k, v in _BOND_LIST
}

# ---------------------------------------------------------------------------
# Angles (k kcal/mol/rad^2, theta0 deg) — key = (a, center, c), symmetric
# ---------------------------------------------------------------------------

_ANGLE_LIST: List[Tuple[Tuple[str, str, str], Tuple[float, float]]] = [
    (("HC", "CT", "HC"), (35.0, 109.50)), (("H1", "CT", "H1"), (35.0, 109.50)),
    (("HP", "CT", "HP"), (35.0, 109.50)),
    (("CT", "CT", "HC"), (50.0, 109.50)), (("CT", "CT", "H1"), (50.0, 109.50)),
    (("CT", "CT", "HP"), (50.0, 109.50)),
    (("CT", "CT", "CT"), (40.0, 109.50)), (("CT", "CT", "N"), (80.0, 109.70)),
    (("CT", "CT", "N3"), (80.0, 111.20)),
    (("C", "CT", "CT"), (63.0, 111.10)), (("N", "CT", "C"), (63.0, 110.10)),
    (("N3", "CT", "C"), (80.0, 111.20)),
    (("CT", "C", "O"), (80.0, 120.40)), (("CT", "C", "N"), (70.0, 116.60)),
    (("O", "C", "N"), (80.0, 122.90)), (("C", "N", "CT"), (50.0, 121.90)),
    (("C", "N", "H"), (50.0, 120.00)), (("CT", "N", "H"), (50.0, 118.04)),
    (("CT", "N", "CT"), (50.0, 118.00)),
    (("H", "N", "H"), (35.0, 120.00)),
    (("H1", "CT", "N"), (50.0, 109.50)), (("H1", "CT", "C"), (50.0, 109.50)),
    (("HC", "CT", "C"), (50.0, 109.50)), (("HP", "CT", "N3"), (50.0, 109.50)),
    (("H1", "CT", "N3"), (50.0, 109.50)),
    (("CT", "N3", "H"), (50.0, 109.50)), (("H", "N3", "H"), (35.0, 109.50)),
    (("CT", "N3", "HP"), (50.0, 109.50)), (("HP", "N3", "HP"), (35.0, 109.50)),
    (("CT", "N3", "CT"), (50.0, 109.50)), (("H", "N3", "HP"), (35.0, 109.50)),
    (("HP", "CT", "C"), (50.0, 109.50)), (("HP", "CT", "CT"), (50.0, 109.50)),
    (("O2", "C", "O2"), (80.0, 126.00)), (("CT", "C", "O2"), (70.0, 117.00)),
    (("CT", "CT", "OH"), (50.0, 109.50)), (("H1", "CT", "OH"), (50.0, 109.50)),
    (("CT", "OH", "HO"), (55.0, 108.50)),
    # carboxylic acid (protonated ASP/GLU: ASH/GLH templates)
    (("CT", "C", "OH"), (70.0, 117.00)), (("O", "C", "OH"), (80.0, 120.00)),
    (("C", "OH", "HO"), (50.0, 113.00)),
    (("CA", "CA", "CA"), (63.0, 120.00)), (("CA", "CA", "HA"), (50.0, 120.00)),
    (("CA", "CA", "CT"), (70.0, 120.00)), (("CA", "CT", "CT"), (63.0, 114.00)),
    (("CA", "CT", "HC"), (50.0, 109.50)),
    (("CA", "CA", "OH"), (70.0, 120.00)), (("CA", "OH", "HO"), (50.0, 113.00)),
    (("CA", "CA", "CB"), (63.0, 120.00)), (("CA", "CA", "CN"), (63.0, 120.00)),
    (("CA", "CB", "CN"), (63.0, 116.20)), (("CA", "CB", "C*"), (63.0, 134.90)),
    (("CA", "CN", "CB"), (63.0, 122.70)), (("CA", "CN", "NA"), (70.0, 132.80)),
    (("CB", "C*", "CT"), (70.0, 128.60)), (("CB", "C*", "CW"), (63.0, 106.40)),
    (("CB", "CA", "HA"), (50.0, 120.00)), (("CB", "CN", "NA"), (70.0, 104.40)),
    (("C*", "CB", "CN"), (63.0, 108.80)), (("C*", "CT", "CT"), (63.0, 115.60)),
    (("C*", "CT", "HC"), (50.0, 109.50)), (("C*", "CW", "H4"), (50.0, 120.00)),
    (("C*", "CW", "NA"), (70.0, 108.70)), (("CT", "C*", "CW"), (70.0, 125.00)),
    (("CN", "NA", "CW"), (70.0, 111.60)), (("CN", "NA", "H"), (50.0, 123.10)),
    (("CW", "NA", "H"), (50.0, 120.00)), (("H4", "CW", "NA"), (50.0, 120.00)),
    (("CN", "CA", "HA"), (50.0, 120.00)),
    # sulfur
    (("CT", "CT", "S"), (50.0, 114.70)), (("CT", "CT", "SH"), (50.0, 108.60)),
    (("CT", "S", "CT"), (62.0, 98.90)), (("CT", "S", "S"), (68.0, 103.70)),
    (("CT", "SH", "HS"), (43.0, 96.00)), (("H1", "CT", "S"), (50.0, 109.50)),
    (("H1", "CT", "SH"), (50.0, 109.50)), (("HC", "CT", "S"), (50.0, 109.50)),
    # histidine-family
    (("CC", "CT", "CT"), (63.0, 113.10)), (("CC", "CT", "HC"), (50.0, 109.50)),
    (("CT", "CC", "CV"), (70.0, 120.00)), (("CT", "CC", "CW"), (70.0, 120.00)),
    (("CT", "CC", "NA"), (70.0, 120.00)), (("CT", "CC", "NB"), (70.0, 120.00)),
    (("CV", "CC", "NA"), (70.0, 120.00)), (("CW", "CC", "NA"), (70.0, 120.00)),
    (("CW", "CC", "NB"), (70.0, 120.00)), (("CC", "CV", "H4"), (50.0, 120.00)),
    (("CC", "CV", "NB"), (70.0, 120.00)), (("CC", "CW", "H4"), (50.0, 120.00)),
    (("CC", "CW", "NA"), (70.0, 120.00)), (("CC", "NA", "CR"), (70.0, 120.00)),
    (("CC", "NA", "H"), (50.0, 120.00)), (("CC", "NB", "CR"), (70.0, 117.00)),
    (("CR", "NA", "CW"), (70.0, 120.00)), (("CR", "NA", "H"), (50.0, 120.00)),
    (("CV", "NB", "CR"), (70.0, 117.00)), (("H4", "CV", "NB"), (50.0, 120.00)),
    (("H5", "CR", "NA"), (50.0, 120.00)), (("H5", "CR", "NB"), (50.0, 120.00)),
    (("NA", "CR", "NB"), (70.0, 120.00)), (("NA", "CR", "NA"), (70.0, 120.00)),
    (("NA", "CW", "H4"), (50.0, 120.00)),
    # arginine guanidinium
    (("CA", "N2", "CT"), (50.0, 123.20)), (("CA", "N2", "H"), (50.0, 120.00)),
    (("CT", "N2", "H"), (50.0, 118.40)), (("H", "N2", "H"), (35.0, 120.00)),
    (("N2", "CA", "N2"), (70.0, 120.00)), (("CT", "CT", "N2"), (80.0, 111.20)),
    (("H1", "CT", "N2"), (50.0, 109.50)),
    # proline-ring strain around N
    (("C", "N", "C"), (50.0, 121.90)),
    # --- nucleic acids (parm94 nucleic section; theta0 to ~0.5 deg) ----
    (("O2", "P", "O2"), (140.0, 119.90)), (("O2", "P", "OS"), (100.0, 108.23)),
    (("OS", "P", "OS"), (45.0, 102.60)), (("O2", "P", "OH"), (100.0, 108.23)),
    (("OS", "P", "OH"), (45.0, 102.60)),
    (("CT", "OS", "P"), (100.0, 120.50)), (("CT", "OS", "CT"), (60.0, 109.50)),
    (("OS", "CT", "CT"), (50.0, 109.50)), (("OS", "CT", "H1"), (50.0, 109.50)),
    (("OS", "CT", "H2"), (50.0, 109.50)), (("OS", "CT", "N*"), (50.0, 109.50)),
    (("CT", "CT", "N*"), (50.0, 109.50)), (("H1", "CT", "N*"), (50.0, 109.50)),
    (("H2", "CT", "N*"), (50.0, 109.50)), (("CT", "CT", "H2"), (50.0, 109.50)),
    (("CT", "N*", "C"), (70.0, 117.60)), (("CT", "N*", "CB"), (70.0, 125.80)),
    (("CT", "N*", "CK"), (70.0, 128.80)), (("CT", "N*", "CM"), (70.0, 121.20)),
    (("CB", "N*", "CK"), (70.0, 105.40)), (("C", "N*", "CM"), (70.0, 121.60)),
    (("CK", "NB", "CB"), (70.0, 103.80)),
    (("N*", "CK", "NB"), (70.0, 113.90)),
    (("N*", "CK", "H5"), (50.0, 123.05)), (("NB", "CK", "H5"), (50.0, 123.05)),
    (("N*", "CB", "CB"), (70.0, 106.20)), (("N*", "CB", "NC"), (70.0, 126.00)),
    (("NB", "CB", "CB"), (70.0, 110.40)), (("NB", "CB", "CA"), (70.0, 132.40)),
    (("NB", "CB", "C"), (70.0, 130.00)), (("CB", "CB", "NC"), (70.0, 127.70)),
    (("CA", "CB", "CB"), (70.0, 117.30)), (("C", "CB", "CB"), (70.0, 119.20)),
    (("CB", "CA", "NC"), (70.0, 117.30)), (("CB", "CA", "N2"), (70.0, 123.50)),
    (("N2", "CA", "NC"), (70.0, 119.30)), (("NA", "CA", "N2"), (70.0, 116.00)),
    (("NA", "CA", "NC"), (70.0, 123.30)),
    (("CM", "CA", "N2"), (70.0, 120.10)), (("CM", "CA", "NC"), (70.0, 121.50)),
    (("CA", "NC", "CB"), (70.0, 112.20)), (("CA", "NC", "CQ"), (70.0, 118.60)),
    (("CQ", "NC", "CB"), (70.0, 111.00)), (("CA", "NC", "C"), (70.0, 120.50)),
    (("NC", "CQ", "NC"), (70.0, 129.10)), (("NC", "CQ", "H5"), (50.0, 115.45)),
    (("C", "NA", "C"), (70.0, 126.40)), (("C", "NA", "CA"), (70.0, 125.20)),
    (("C", "NA", "H"), (30.0, 116.80)), (("CA", "NA", "H"), (30.0, 118.00)),
    (("N*", "C", "NA"), (70.0, 115.40)), (("N*", "C", "NC"), (70.0, 118.60)),
    (("N*", "C", "O"), (80.0, 120.90)), (("NA", "C", "O"), (80.0, 120.60)),
    (("NC", "C", "O"), (80.0, 122.50)),
    (("CB", "C", "NA"), (70.0, 111.30)), (("CB", "C", "O"), (80.0, 128.80)),
    (("CM", "C", "NA"), (70.0, 114.10)), (("CM", "C", "O"), (80.0, 125.30)),
    (("CM", "CM", "C"), (70.0, 120.70)), (("CM", "CM", "CA"), (70.0, 117.00)),
    (("CM", "CM", "CT"), (70.0, 119.70)), (("CM", "CM", "HA"), (50.0, 119.70)),
    (("CM", "CM", "H4"), (50.0, 119.70)),
    (("N*", "CM", "CM"), (70.0, 121.20)), (("N*", "CM", "H4"), (50.0, 119.10)),
    (("CT", "CM", "C"), (70.0, 119.70)), (("CM", "CT", "HC"), (50.0, 109.50)),
    (("HA", "CM", "CA"), (50.0, 123.30)),
    (("HA", "CM", "C"), (50.0, 119.70)),   # uracil H5-C5-C4 (parm99)
    # TIP3P water (flexible fallback)
    (("HW", "OW", "HW"), (100.0, 104.52)),
    (("HW", "OW4", "HW"), (100.0, 104.52)),
    # zero-k angles to the virtual site (exclusion graph only)
    (("HW", "OW4", "MW"), (0.0, 52.26)),
    (("HW", "OW5", "HW"), (100.0, 104.52)),
    (("HW", "OW5", "LW"), (0.0, 110.69)),
    (("LW", "OW5", "LW"), (0.0, 109.47)),
]
ANGLE_PARAMS: Dict[Tuple[str, str, str], Tuple[float, float]] = {}
for (a, b, c), v in _ANGLE_LIST:
    ANGLE_PARAMS[(a, b, c)] = v
    ANGLE_PARAMS[(c, b, a)] = v

# ---------------------------------------------------------------------------
# Proper dihedrals. Specific (A,B,C,D) keys take precedence over wildcard
# ("X",B,C,"X"). Each value: list of (divider, PK, phase_deg, periodicity).
# Backbone phi/psi corrections follow ff99SB (frcmod.ff99SB).
# ---------------------------------------------------------------------------

DihedralTerm = Tuple[float, float, float, float]

DIHEDRAL_PARAMS: Dict[Tuple[str, str, str, str], List[DihedralTerm]] = {
    # wildcards (parm10.dat)
    ("X", "C", "N", "X"): [(4, 10.00, 180.0, 2)],
    ("X", "CT", "N", "X"): [(6, 0.00, 0.0, 2)],
    ("X", "CT", "CT", "X"): [(9, 1.40, 0.0, 3)],
    ("X", "CT", "C", "X"): [(4, 0.00, 0.0, 2)],
    ("X", "CT", "N3", "X"): [(9, 1.40, 0.0, 3)],
    ("X", "CT", "OH", "X"): [(3, 0.50, 0.0, 3)],
    ("X", "CT", "N2", "X"): [(6, 0.00, 0.0, 3)],
    ("X", "CA", "CA", "X"): [(4, 14.50, 180.0, 2)],
    ("X", "CA", "CT", "X"): [(6, 0.00, 0.0, 2)],
    ("X", "CA", "OH", "X"): [(2, 1.80, 180.0, 2)],
    ("X", "CA", "N2", "X"): [(4, 9.60, 180.0, 2)],
    ("X", "C*", "CW", "X"): [(4, 26.10, 180.0, 2)],
    ("X", "C*", "CB", "X"): [(4, 6.70, 180.0, 2)],
    ("X", "C*", "CT", "X"): [(6, 0.00, 0.0, 2)],
    ("X", "CB", "CN", "X"): [(4, 12.00, 180.0, 2)],
    ("X", "CA", "CB", "X"): [(4, 14.00, 180.0, 2)],
    ("X", "CA", "CN", "X"): [(4, 14.50, 180.0, 2)],
    ("X", "CW", "NA", "X"): [(4, 6.00, 180.0, 2)],
    ("X", "CN", "NA", "X"): [(4, 6.10, 180.0, 2)],
    ("X", "CT", "S", "X"): [(3, 1.00, 0.0, 3)],
    ("X", "CT", "SH", "X"): [(3, 0.75, 0.0, 3)],
    ("X", "S", "S", "X"): [(2, 3.50, 0.0, 2)],
    ("X", "CC", "CT", "X"): [(6, 0.00, 0.0, 2)],
    ("X", "CC", "CV", "X"): [(4, 20.60, 180.0, 2)],
    ("X", "CC", "CW", "X"): [(4, 21.50, 180.0, 2)],
    ("X", "CC", "NA", "X"): [(4, 5.60, 180.0, 2)],
    ("X", "CC", "NB", "X"): [(2, 4.80, 180.0, 2)],
    ("X", "CV", "NB", "X"): [(2, 4.80, 180.0, 2)],
    ("X", "CR", "NA", "X"): [(4, 9.30, 180.0, 2)],
    ("X", "CR", "NB", "X"): [(2, 10.00, 180.0, 2)],
    ("X", "C", "OH", "X"): [(2, 4.60, 180.0, 2)],
    # nucleic acids (parm94/99 wildcards; the OL15 alpha/gamma/eps/zeta/
    # chi REFITS are approximated by these ancestors — md/nucleic.py
    # docstring records the provenance decision)
    ("X", "CT", "OS", "X"): [(3, 1.15, 0.0, 3)],
    ("X", "OS", "P", "X"): [(3, 0.75, 0.0, 3)],
    ("X", "OH", "P", "X"): [(3, 0.75, 0.0, 3)],
    ("X", "CT", "N*", "X"): [(6, 0.00, 0.0, 2)],
    ("X", "C", "NA", "X"): [(4, 5.40, 180.0, 2)],
    ("X", "C", "N*", "X"): [(4, 5.80, 180.0, 2)],
    ("X", "C", "NC", "X"): [(2, 8.00, 180.0, 2)],
    ("X", "CB", "N*", "X"): [(4, 6.60, 180.0, 2)],
    ("X", "CB", "NB", "X"): [(2, 5.10, 180.0, 2)],
    ("X", "CB", "NC", "X"): [(2, 8.30, 180.0, 2)],
    ("X", "CK", "N*", "X"): [(4, 6.80, 180.0, 2)],
    ("X", "CK", "NB", "X"): [(2, 20.00, 180.0, 2)],
    ("X", "CA", "NC", "X"): [(2, 9.60, 180.0, 2)],
    ("X", "CA", "NA", "X"): [(4, 6.00, 180.0, 2)],
    ("X", "CQ", "NC", "X"): [(2, 13.60, 180.0, 2)],
    ("X", "CM", "N*", "X"): [(4, 7.40, 180.0, 2)],
    ("X", "CM", "CM", "X"): [(4, 26.60, 180.0, 2)],
    ("X", "C", "CM", "X"): [(4, 8.70, 180.0, 2)],
    ("X", "CA", "CM", "X"): [(4, 10.20, 180.0, 2)],
    ("X", "CB", "CB", "X"): [(4, 21.80, 180.0, 2)],
    ("X", "C", "CB", "X"): [(4, 12.00, 180.0, 2)],
    ("X", "CM", "CT", "X"): [(6, 0.00, 0.0, 3)],
    # parm99 sugar specifics (gauche effects)
    ("OS", "CT", "CT", "OS"): [(1, 0.144, 0.0, 3), (1, 1.175, 0.0, 2)],
    ("OS", "CT", "CT", "OH"): [(1, 0.144, 0.0, 3), (1, 1.175, 0.0, 2)],
    ("OH", "CT", "CT", "OH"): [(1, 0.144, 0.0, 3), (1, 1.175, 0.0, 2)],
    # ff99SB backbone corrections (specific, override wildcards)
    ("C", "N", "CT", "C"): [   # phi
        (1, 0.00, 0.0, 1), (1, 0.27, 0.0, 2), (1, 0.42, 0.0, 3),
    ],
    ("N", "CT", "C", "N"): [   # psi
        (1, 0.45, 180.0, 1), (1, 1.58, 180.0, 2), (1, 0.55, 180.0, 3),
    ],
    ("CT", "CT", "N", "C"): [  # phi' (side-chain-adjacent)
        (1, 2.00, 0.0, 1), (1, 2.00, 0.0, 2), (1, 0.40, 0.0, 3),
    ],
    ("CT", "CT", "C", "N"): [  # psi'
        (1, 0.20, 0.0, 1), (1, 0.20, 0.0, 2), (1, 0.40, 0.0, 3),
    ],
    # glycine-specific terms reuse the wildcard X-CT-N-X / X-CT-C-X zeros.
    ("H", "N", "C", "O"): [(1, 2.50, 180.0, 2), (1, 2.00, 0.0, 1)],
    ("CT", "S", "S", "CT"): [(1, 3.50, 0.0, 2), (1, 0.60, 0.0, 3)],
    ("OH", "CT", "CT", "N"): [(1, 0.80, 0.0, 3)],  # THR/SER chi approx
}

# ---------------------------------------------------------------------------
# Impropers: key = (i, j, center, l) with wildcards "X" in i/j slots; the
# amber convention places the central atom third. Value: (PK, phase, n).
# ---------------------------------------------------------------------------

IMPROPER_PARAMS: Dict[Tuple[str, str, str, str], Tuple[float, float, float]] = {
    ("X", "X", "C", "O"): (10.5, 180.0, 2),
    ("X", "O2", "C", "O2"): (10.5, 180.0, 2),
    ("X", "X", "N", "H"): (1.0, 180.0, 2),
    ("X", "X", "N2", "H"): (1.0, 180.0, 2),
    ("X", "X", "NA", "H"): (1.0, 180.0, 2),
    ("X", "X", "CA", "HA"): (1.1, 180.0, 2),
    ("X", "X", "CW", "H4"): (1.1, 180.0, 2),
    ("X", "X", "CV", "H4"): (1.1, 180.0, 2),
    # nucleic base sp2 hydrogens / amino planarity
    ("X", "X", "CK", "H5"): (1.1, 180.0, 2),
    ("X", "X", "CQ", "H5"): (1.1, 180.0, 2),
    ("X", "X", "CM", "H4"): (1.1, 180.0, 2),
    ("X", "X", "CM", "HA"): (1.1, 180.0, 2),
    ("X", "X", "CR", "H5"): (1.1, 180.0, 2),
    ("X", "N2", "CA", "N2"): (10.5, 180.0, 2),
    ("CT", "CW", "C*", "CB"): (1.1, 180.0, 2),
    ("CA", "CA", "CA", "CT"): (1.1, 180.0, 2),
    ("CA", "CA", "CA", "OH"): (1.1, 180.0, 2),
    ("CA", "CA", "CN", "NA"): (1.1, 180.0, 2),
    ("CB", "CW", "NA", "H"): (1.1, 180.0, 2),
    ("CT", "C", "N", "H"): (1.1, 180.0, 2),
    ("CT", "C", "N", "CT"): (1.1, 180.0, 2),
}

# ---------------------------------------------------------------------------
# GB (OBC-family) intrinsic radii (mbondi2, A) and HCT screening by element;
# hydrogens bonded to N use 1.3 A (mbondi2 rule).
# ---------------------------------------------------------------------------

GB_RADII_BY_ELEMENT: Dict[str, float] = {
    "H": 1.20, "C": 1.70, "N": 1.55, "O": 1.50, "S": 1.80, "P": 1.85,
}
GB_RADIUS_H_ON_N: float = 1.30
GB_SCREEN_BY_ELEMENT: Dict[str, float] = {
    "H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85, "S": 0.96, "P": 0.86,
}

#: Amber 1-4 scale factors.
SCEE = 1.0 / 1.2   # electrostatic 1-4 multiplier
SCNB = 1.0 / 2.0   # LJ 1-4 multiplier

#: OBC2 (igb=5) rescale coefficients.
OBC2_ALPHA, OBC2_BETA, OBC2_GAMMA = 1.0, 0.8, 4.85
#: Dielectric offset (nm) applied to intrinsic radii inside the GB model.
GB_DIELECTRIC_OFFSET = 0.009


def lookup_bond(type_a: str, type_b: str) -> Tuple[float, float]:
    key = frozenset((type_a, type_b))
    try:
        return BOND_PARAMS[key]
    except KeyError:
        raise KeyError(f"no bond parameters for types {type_a}-{type_b}")


def lookup_angle(ta: str, tb: str, tc: str) -> Tuple[float, float]:
    try:
        return ANGLE_PARAMS[(ta, tb, tc)]
    except KeyError:
        raise KeyError(f"no angle parameters for types {ta}-{tb}-{tc}")


def lookup_dihedral(
    ta: str, tb: str, tc: str, td: str
) -> List[DihedralTerm]:
    """Specific match first (both orders), then wildcard (both orders)."""
    for key in ((ta, tb, tc, td), (td, tc, tb, ta)):
        if key in DIHEDRAL_PARAMS:
            return DIHEDRAL_PARAMS[key]
    for key in (("X", tb, tc, "X"), ("X", tc, tb, "X")):
        if key in DIHEDRAL_PARAMS:
            return DIHEDRAL_PARAMS[key]
    raise KeyError(f"no dihedral parameters for types {ta}-{tb}-{tc}-{td}")


def lookup_improper(ti: str, tj: str, tc: str, tl: str):
    """Improper lookup with wildcard degradation; returns None if absent."""
    # specific
    for i, j in ((ti, tj), (tj, ti)):
        if (i, j, tc, tl) in IMPROPER_PARAMS:
            return IMPROPER_PARAMS[(i, j, tc, tl)]
    # one wildcard
    for other in (ti, tj):
        if ("X", other, tc, tl) in IMPROPER_PARAMS:
            return IMPROPER_PARAMS[("X", other, tc, tl)]
        if (other, "X", tc, tl) in IMPROPER_PARAMS:
            return IMPROPER_PARAMS[(other, "X", tc, tl)]
    # two wildcards
    return IMPROPER_PARAMS.get(("X", "X", tc, tl))
