"""Loaders for user-supplied Amber parameter files (frcmod / parm.dat /
OFF .lib residue libraries).

The reference reaches lipid17 and the OL15/OL3 nucleic torsion refits
through OpenMM's bundled ``amber14-all.xml`` (reference
src/pmarlo/simulation/__init__.py:64-67). This image ships none of
those data files and has no egress (ROUND4/5 sourcing notes), so the
first-party tables in md/ff_params.py carry the ff94/ff99SB/ff14SB
lineage only. This module closes the gap OPERATIONALLY: a user who has
the AmberTools data files (``frcmod.OL15``, ``lipid17.dat``,
``lipid17.lib``, ...) loads them here and the framework picks the
refits/new residues up exactly like its built-in tables —

    from pmarlo_tpu.md.amber_params import load_amber_files
    load_amber_files("frcmod.OL15")                    # torsion refits
    load_amber_files("lipid17.dat", "lipid17.lib")     # new FF + residues

Parsing follows the PUBLISHED Amber file formats (Amber reference
manual, PARM/FRCMOD/OFF): fixed-width dash-separated type fields for
bonded records, negative periodicity marking dihedral-term
continuation, MOD4/RE Rmin-eps nonbonded blocks with type equivalence
lists, and ``!entry.<RES>.unit.*`` tables in OFF libraries.

Registration mutates the process-global tables in md/ff_params.py and
md/residues.py — the same semantics as OpenMM's ``ForceField`` XML
loading that the reference relies on. ``parameter_snapshot()`` gives
tests a scoped restore.

Host copy of ``pmarlo_tpu/md/amber_params.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import ff_params as ff
from . import residues as res

# nearest-mass element inference for types the built-in tables have
# never seen (GB radii / hydrogen detection key on the element)
_ELEMENT_MASSES = [
    ("H", 1.008), ("C", 12.011), ("N", 14.007), ("O", 15.999),
    ("F", 18.998), ("Na", 22.990), ("Mg", 24.305), ("P", 30.974),
    ("S", 32.06), ("Cl", 35.45), ("K", 39.098), ("Ca", 40.078),
    ("Fe", 55.845), ("Zn", 65.38), ("Br", 79.904), ("I", 126.904),
]


def _element_from_mass(mass: float) -> str:
    if mass <= 0.0:
        return "M"          # massless virtual site
    return min(_ELEMENT_MASSES, key=lambda em: abs(em[1] - mass))[0]


@dataclass
class AmberParameterSet:
    """Parsed parameter records, in the md/ff_params.py table units
    (kcal/mol, Angstrom, degrees — converted to kJ/nm at System build)."""

    title: str = ""
    masses: Dict[str, float] = field(default_factory=dict)
    bonds: Dict[frozenset, Tuple[float, float]] = field(default_factory=dict)
    angles: Dict[Tuple[str, str, str], Tuple[float, float]] = (
        field(default_factory=dict))
    dihedrals: Dict[Tuple[str, str, str, str], List[ff.DihedralTerm]] = (
        field(default_factory=dict))
    impropers: Dict[Tuple[str, str, str, str],
                    Tuple[float, float, float]] = field(default_factory=dict)
    lj: Dict[str, Tuple[float, float]] = field(default_factory=dict)

    def merge(self, other: "AmberParameterSet") -> "AmberParameterSet":
        self.masses.update(other.masses)
        self.bonds.update(other.bonds)
        self.angles.update(other.angles)
        self.dihedrals.update(other.dihedrals)
        self.impropers.update(other.impropers)
        self.lj.update(other.lj)
        return self


class AmberFormatError(ValueError):
    """Raised on malformed parameter/library files (fail fast, with the
    offending line in the message)."""


def _types_from_dashes(line: str, n: int) -> Optional[Tuple[str, ...]]:
    """Read ``n`` dash-separated fixed-width type fields ("C -N -CT-C ").

    Canonical writers emit 2-char fields at stride 3; hand-edited files
    sometimes vary, so fall back to splitting the leading token run on
    '-'. Returns None when the line does not look like a bonded record.
    """
    width = 3 * n - 1
    head = line[:width]
    if head.count("-") == n - 1 and all(
        head[i] == "-" for i in range(2, width, 3)
    ):
        fields = tuple(head[i:i + 2].strip() for i in range(0, width, 3))
        if all(fields):
            return fields
    m = re.match(r"\s*([\w\*\+]{1,4}(?:\s*-\s*[\w\*\+]{1,4}){%d})" % (n - 1),
                 line)
    if m is None:
        return None
    fields = tuple(t.strip() for t in m.group(1).split("-"))
    return fields if len(fields) == n else None


def _floats_after_types(line: str, n_types: int) -> List[float]:
    width = 3 * n_types - 1
    out = []
    for tok in line[width:].split():
        try:
            out.append(float(tok))
        except ValueError:
            break               # trailing comment
    return out


def _parse_mass_line(line: str, pset: AmberParameterSet) -> None:
    toks = line.split()
    if len(toks) < 2:
        raise AmberFormatError(f"bad MASS line: {line!r}")
    pset.masses[toks[0]] = float(toks[1])


def _parse_bond_line(line: str, pset: AmberParameterSet) -> None:
    types = _types_from_dashes(line, 2)
    vals = _floats_after_types(line, 2) if types else []
    if not types or len(vals) < 2:
        raise AmberFormatError(f"bad BOND line: {line!r}")
    pset.bonds[frozenset(types)] = (vals[0], vals[1])


def _parse_angle_line(line: str, pset: AmberParameterSet) -> None:
    types = _types_from_dashes(line, 3)
    vals = _floats_after_types(line, 3) if types else []
    if not types or len(vals) < 2:
        raise AmberFormatError(f"bad ANGLE line: {line!r}")
    pset.angles[types] = (vals[0], vals[1])


class _DiheState:
    """Continuation tracker: a NEGATIVE periodicity means more Fourier
    terms for the same type quadruple follow on subsequent lines."""

    def __init__(self) -> None:
        self.open_key: Optional[Tuple[str, str, str, str]] = None


def _parse_dihe_line(line: str, pset: AmberParameterSet,
                     st: _DiheState) -> None:
    types = _types_from_dashes(line, 4)
    vals = _floats_after_types(line, 4) if types else []
    if not types or len(vals) < 4:
        raise AmberFormatError(f"bad DIHE line: {line!r}")
    idivf, pk, phase, pn = vals[:4]
    key = types
    if st.open_key is not None and types == st.open_key:
        terms = pset.dihedrals[key]
    else:
        terms = []
        pset.dihedrals[key] = terms
    terms.append((float(idivf), float(pk), float(phase), abs(float(pn))))
    st.open_key = key if pn < 0 else None


def _parse_improper_line(line: str, pset: AmberParameterSet) -> None:
    types = _types_from_dashes(line, 4)
    vals = _floats_after_types(line, 4) if types else []
    if not types or len(vals) < 3:
        raise AmberFormatError(f"bad IMPROPER line: {line!r}")
    pk, phase, pn = vals[:3]
    # amber improper convention: central atom is THIRD; md/ff_params
    # stores (i, j, center, l) the same way
    pset.impropers[types] = (float(pk), float(phase), abs(float(pn)))


def _parse_nonbon_line(line: str, pset: AmberParameterSet) -> None:
    toks = line.split()
    if len(toks) < 3:
        raise AmberFormatError(f"bad NONBON line: {line!r}")
    pset.lj[toks[0]] = (float(toks[1]), float(toks[2]))


_FRCMOD_SECTIONS = {
    "MASS": "mass", "BOND": "bond", "ANGL": "angle", "DIHE": "dihe",
    "IMPR": "improper", "NONB": "nonbon", "HBON": "skip",
    "LJED": "skip", "CMAP": "skip", "IPOL": "skip",
}


def parse_frcmod(text: str) -> AmberParameterSet:
    """Parse Amber frcmod content (MASS/BOND/ANGLE/DIHE/IMPROPER/NONBON
    sections introduced by keyword lines; first line is the title)."""
    pset = AmberParameterSet()
    lines = text.splitlines()
    if lines:
        pset.title = lines[0].strip()
    section = None
    st = _DiheState()
    for raw in lines[1:]:
        line = raw.rstrip()
        stripped = line.strip()
        if not stripped:
            section = None
            continue
        key = stripped[:4].upper()
        if key == "END":
            break
        if key in _FRCMOD_SECTIONS and (
            len(stripped) <= 8 or stripped.upper().startswith("NONBON")
        ):
            section = _FRCMOD_SECTIONS[key]
            st = _DiheState()
            continue
        if section is None or section == "skip":
            continue
        if section == "mass":
            _parse_mass_line(line, pset)
        elif section == "bond":
            _parse_bond_line(line, pset)
        elif section == "angle":
            _parse_angle_line(line, pset)
        elif section == "dihe":
            _parse_dihe_line(line, pset, st)
        elif section == "improper":
            _parse_improper_line(line, pset)
        elif section == "nonbon":
            _parse_nonbon_line(line, pset)
    return pset


def parse_parm_dat(text: str) -> AmberParameterSet:
    """Parse a full Amber parm.dat main parameter file.

    Layout (Amber reference manual): title; MASS block; blank; one
    hydrophilic-types line; BOND block; blank; ANGLE; blank; DIHE;
    blank; IMPROPER; blank; HBOND 10-12 block; blank; LJ equivalence
    lines; blank; ``MOD4 ... RE`` introducing Rmin/eps NONBON entries;
    END. Equivalenced types inherit the representative's LJ row."""
    pset = AmberParameterSet()
    lines = text.splitlines()
    if not lines:
        return pset
    pset.title = lines[0].strip()

    # split the remainder into blank-separated blocks
    blocks: List[List[str]] = [[]]
    for raw in lines[1:]:
        if raw.strip().upper() == "END":
            break
        if raw.strip():
            blocks[-1].append(raw.rstrip())
        elif blocks[-1]:
            blocks.append([])
    if blocks and not blocks[-1]:
        blocks.pop()

    equiv: List[List[str]] = []
    st = _DiheState()
    bonded_done = 0     # 0=mass, 1=bond, 2=angle, 3=dihe, 4=improper
    for blk in blocks:
        first = blk[0]
        if bonded_done == 0:
            for ln in blk:
                _parse_mass_line(ln, pset)
            bonded_done = 1
            continue
        if bonded_done == 1:
            # the hydrophilic-types line precedes the bonds INSIDE this
            # block (no blank between them): detect it by the absence
            # of dash-separated fields + floats
            rows = blk
            if (_types_from_dashes(first, 2) is None
                    or len(_floats_after_types(first, 2)) < 2):
                rows = blk[1:]
            for ln in rows:
                _parse_bond_line(ln, pset)
            bonded_done = 2
            continue
        if bonded_done == 2:
            for ln in blk:
                _parse_angle_line(ln, pset)
            bonded_done = 3
            continue
        if bonded_done == 3:
            for ln in blk:
                _parse_dihe_line(ln, pset, st)
            bonded_done = 4
            continue
        if bonded_done == 4:
            for ln in blk:
                _parse_improper_line(ln, pset)
            bonded_done = 5
            continue
        # post-bonded blocks, recognized by content
        up = first.upper()
        if up.startswith("MOD4") or "RE" == up.split()[-1] and "MOD" in up:
            for ln in blk[1:]:
                _parse_nonbon_line(ln, pset)
            continue
        toks = first.split()
        if all(re.fullmatch(r"[\w\*\+\-]{1,4}", t) for t in toks):
            is_hbond = len(toks) >= 4 and any(
                re.fullmatch(r"[0-9.]+", t) for t in toks[2:])
            if is_hbond:
                continue        # HBOND 10-12 block: obsolete, skipped
            for ln in blk:      # LJ equivalence lists
                equiv.append(ln.split())
            continue
        # anything else (HBOND with floats etc.): skip
    for row in equiv:
        if not row:
            continue
        rep = row[0]
        if rep in pset.lj:
            for t in row[1:]:
                pset.lj.setdefault(t, pset.lj[rep])
    return pset


# ---------------------------------------------------------------- OFF .lib


def parse_off_lib(text: str) -> Dict[str, res.ResidueTemplate]:
    """Parse an Amber OFF residue library (.lib/.off) into md/residues
    template dicts: atoms {name: (type, charge)}, intra-residue bonds,
    head/tail from the unit connect array."""
    entries: Dict[str, dict] = {}
    current: Optional[Tuple[str, str]] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("!!"):
            current = None
            continue
        if line.startswith("!"):
            m = re.match(r"!entry\.([^.]+)\.unit\.(\w+)", line)
            current = (m.group(1), m.group(2)) if m else None
            if current is not None:
                entries.setdefault(current[0], {}).setdefault(
                    current[1], [])
            continue
        if current is None:
            continue
        entries[current[0]][current[1]].append(line)

    out: Dict[str, res.ResidueTemplate] = {}
    for name, tables in entries.items():
        atom_rows = tables.get("atoms", [])
        if not atom_rows:
            continue
        atoms: Dict[str, Tuple[str, float]] = {}
        order: List[str] = []
        for row in atom_rows:
            toks = row.split()
            # str name str type int typex int resx int flags int seq
            # int elmnt dbl chg
            if len(toks) < 8:
                raise AmberFormatError(f"bad OFF atom row: {row!r}")
            aname = toks[0].strip('"')
            atype = toks[1].strip('"')
            atoms[aname] = (atype, float(toks[7]))
            order.append(aname)
        bonds: List[Tuple[str, str]] = []
        for row in tables.get("connectivity", []):
            toks = row.split()
            if len(toks) < 2:
                raise AmberFormatError(f"bad OFF connectivity row: {row!r}")
            i, j = int(toks[0]) - 1, int(toks[1]) - 1
            if not (0 <= i < len(order) and 0 <= j < len(order)):
                raise AmberFormatError(
                    f"OFF connectivity index out of range: {row!r}")
            bonds.append((order[i], order[j]))
        head = tail = None
        conn = [int(r.split()[0]) for r in tables.get("connect", [])
                if r.split()]
        if len(conn) >= 1 and conn[0] > 0:
            head = order[conn[0] - 1]
        if len(conn) >= 2 and conn[1] > 0:
            tail = order[conn[1] - 1]
        out[name.upper()] = {
            "atoms": atoms, "bonds": bonds, "head": head, "tail": tail,
        }
    return out


# ------------------------------------------------------------ registration


def install_parameters(pset: AmberParameterSet) -> Dict[str, int]:
    """Merge a parsed parameter set into the live md/ff_params tables
    (process-global, mirroring OpenMM ForceField-XML semantics). New
    atom types get masses/elements registered; existing entries are
    OVERRIDDEN — that is the point of a refit frcmod. Returns counts."""
    n_new_types = 0
    for t, m in pset.masses.items():
        if t not in ff.TYPE_MASSES:
            n_new_types += 1
        ff.TYPE_MASSES[t] = m
        ff.TYPE_ELEMENTS[t] = _element_from_mass(m)
    ff.BOND_PARAMS.update(pset.bonds)
    for key, v in pset.angles.items():
        ff.ANGLE_PARAMS[key] = v
        ff.ANGLE_PARAMS[key[::-1]] = v
    for key, terms in pset.dihedrals.items():
        ff.DIHEDRAL_PARAMS[key] = list(terms)
        # drop a stale reversed-order entry so the refit always wins
        # (lookup_dihedral tries both orders)
        if key[::-1] != key:
            ff.DIHEDRAL_PARAMS.pop(key[::-1], None)
    ff.IMPROPER_PARAMS.update(pset.impropers)
    ff.TYPE_LJ.update(pset.lj)
    return {
        "new_types": n_new_types,
        "bonds": len(pset.bonds),
        "angles": len(pset.angles),
        "dihedrals": len(pset.dihedrals),
        "impropers": len(pset.impropers),
        "lj": len(pset.lj),
    }


def install_templates(
    templates: Dict[str, res.ResidueTemplate], *, nonpolymer: bool = False,
) -> List[str]:
    """Register OFF residue templates. ``nonpolymer=True`` marks them as
    standalone units (ions/cofactors) exempt from terminal variants."""
    names = []
    for name, tmpl in templates.items():
        res.TEMPLATES[name] = tmpl
        if nonpolymer:
            res.NONPOLYMER.add(name)
        names.append(name)
    return sorted(names)


def load_amber_files(*paths: str, nonpolymer_lib: bool = False) -> dict:
    """Load any mix of frcmod / parm.dat / OFF .lib files (dispatch by
    content) and register everything. Returns a summary dict."""
    summary: dict = {"parameters": {}, "residues": []}
    pset = AmberParameterSet()
    for path in paths:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            text = fh.read()
        if "!!index" in text or "!entry." in text:
            tmpls = parse_off_lib(text)
            summary["residues"] += install_templates(
                tmpls, nonpolymer=nonpolymer_lib)
        elif _looks_like_frcmod(text):
            pset.merge(parse_frcmod(text))
        else:
            pset.merge(parse_parm_dat(text))
    if pset.masses or pset.bonds or pset.dihedrals or pset.lj:
        summary["parameters"] = install_parameters(pset)
    return summary


def _looks_like_frcmod(text: str) -> bool:
    keys = {"MASS", "BOND", "ANGL", "DIHE", "IMPR", "NONB"}
    hits = sum(
        1 for ln in text.splitlines()[1:60]
        if ln.strip()[:4].upper() in keys and len(ln.strip()) <= 8
    )
    return hits >= 2


@contextlib.contextmanager
def parameter_snapshot():
    """Scoped restore of every table this module mutates (for tests)."""
    saved = (
        dict(ff.TYPE_MASSES), dict(ff.TYPE_ELEMENTS), dict(ff.TYPE_LJ),
        dict(ff.BOND_PARAMS), dict(ff.ANGLE_PARAMS),
        {k: list(v) for k, v in ff.DIHEDRAL_PARAMS.items()},
        dict(ff.IMPROPER_PARAMS), dict(res.TEMPLATES),
        set(res.NONPOLYMER),
    )
    try:
        yield
    finally:
        (masses, elements, lj, bonds, angles, dihes, imps, tmpl,
         nonpoly) = saved
        for live, snap in (
            (ff.TYPE_MASSES, masses), (ff.TYPE_ELEMENTS, elements),
            (ff.TYPE_LJ, lj), (ff.BOND_PARAMS, bonds),
            (ff.ANGLE_PARAMS, angles), (ff.DIHEDRAL_PARAMS, dihes),
            (ff.IMPROPER_PARAMS, imps), (res.TEMPLATES, tmpl),
        ):
            live.clear()
            live.update(snap)
        res.NONPOLYMER.clear()
        res.NONPOLYMER.update(nonpoly)


__all__ = [
    "AmberParameterSet", "AmberFormatError",
    "parse_frcmod", "parse_parm_dat", "parse_off_lib",
    "install_parameters", "install_templates", "load_amber_files",
    "parameter_snapshot",
]
