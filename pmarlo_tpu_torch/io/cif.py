"""Minimal, dependency-free mmCIF (PDBx) structure reading.

The reference `Protein` accepts ``.cif`` inputs (reference:
src/pmarlo/protein/protein.py:137 routes them through PDBFixer's
PdbxFile loader). New PDB depositions and AlphaFold models are
mmCIF-first, so the prep layer needs a real intake path, not a
PDB-only one. This module parses the ``_atom_site`` loop (plus
``_cell`` and ``_pdbx_poly_seq_scheme``/``_entity_poly_seq``) into the
same :class:`~pmarlo_tpu.io.pdb.PDBStructure` the rest of the prep
pipeline consumes, so everything downstream (repair, hydrogens,
solvation, force-field build) is format-agnostic.

Only STAR syntax actually used by structure files is implemented:
``loop_`` blocks, quoted tokens (single/double), ``;``-delimited
multi-line text fields, ``#`` comments, and plain ``_key value``
pairs. Coordinates are returned in nanometers.

Host copy of ``pmarlo_tpu/io/cif.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..md.residues import NONPOLYMER as _HETEROGENS
from .pdb import PDBAtom, PDBResidue, PDBStructure, _guess_element

logger = logging.getLogger("pmarlo_tpu")


def _tokenize_line(line: str) -> List[str]:
    """Split one mmCIF data line into tokens, honoring ' and " quoting.

    Per the STAR spec a quote only closes when followed by whitespace or
    end-of-line (so ``'it's'`` is a single token); quotes interior to a
    bare token are literal.
    """
    tokens: List[str] = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c in " \t":
            i += 1
            continue
        if c == "#":
            break
        if c in "'\"":
            quote = c
            j = i + 1
            while j < n:
                if line[j] == quote and (j + 1 == n or line[j + 1] in " \t"):
                    break
                j += 1
            tokens.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


def _token_stream(lines: List[str], start: int) -> Iterator[Tuple[int, str]]:
    """Yield (next_line_index, token) from ``start``, handling
    ``;``-delimited multi-line text values."""
    i = start
    while i < len(lines):
        line = lines[i]
        if line.startswith(";"):
            # multi-line text field: consume until the closing ';'
            chunks = [line[1:]]
            i += 1
            while i < len(lines) and not lines[i].startswith(";"):
                chunks.append(lines[i])
                i += 1
            i += 1  # skip the closing ';'
            yield i, "\n".join(chunks).strip()
            continue
        for tok in _tokenize_line(line):
            yield i + 1, tok
        i += 1


class _CifBlock:
    """One data block: scalar items + loop tables, keys lowercased."""

    def __init__(self) -> None:
        self.scalars: Dict[str, str] = {}
        #: category -> (column names, rows)
        self.loops: Dict[str, Tuple[List[str], List[List[str]]]] = {}

    def loop(self, category: str) -> "Tuple[List[str], List[List[str]]] | None":
        return self.loops.get(category.lower())

    def scalar(self, key: str) -> Optional[str]:
        return self.scalars.get(key.lower())


def _parse_cif(path: Path) -> _CifBlock:
    """Parse the first data block of an mmCIF file."""
    lines = path.read_text().splitlines()
    block = _CifBlock()
    i = 0
    n = len(lines)
    seen_data = False
    while i < n:
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        low = line.lower()
        if low.startswith("data_"):
            if seen_data:
                break  # only the first block (multi-block files are rare)
            seen_data = True
            i += 1
            continue
        if low == "loop_":
            i += 1
            headers: List[str] = []
            while i < n and lines[i].strip().startswith("_"):
                headers.append(lines[i].strip().split()[0].lower())
                i += 1
            if not headers:
                continue
            category = headers[0].split(".")[0]
            columns = [h.split(".", 1)[1] if "." in h else h for h in headers]
            rows: List[List[str]] = []
            row: List[str] = []
            stream = _token_stream(lines, i)
            last_i = i
            for next_i, tok in stream:
                if tok.startswith("_") or tok.lower() in (
                    "loop_", "stop_",
                ) or tok.lower().startswith("data_"):
                    break
                row.append(tok)
                last_i = next_i
                if len(row) == len(headers):
                    rows.append(row)
                    row = []
            i = last_i
            if category in block.loops:
                # merged models can split atom_site; extend
                old_cols, old_rows = block.loops[category]
                if old_cols == columns:
                    old_rows.extend(rows)
                    i = max(i, last_i)
                    continue
            block.loops[category] = (columns, rows)
            continue
        if line.startswith("_"):
            toks = _tokenize_line(line)
            key = toks[0].lower()
            if len(toks) >= 2:
                block.scalars[key] = toks[1]
            else:
                # value on the following line(s) (possibly ';' text)
                for next_i, tok in _token_stream(lines, i + 1):
                    block.scalars[key] = tok
                    i = next_i - 1
                    break
            i += 1
            continue
        i += 1
    return block


def _col(columns: List[str], *names: str) -> Optional[int]:
    for name in names:
        if name in columns:
            return columns.index(name)
    return None


_MISSING = {".", "?", ""}


def read_cif(path: "str | Path", model: int = 1) -> PDBStructure:
    """Parse an mmCIF/PDBx structure file into a :class:`PDBStructure`.

    Selects the given model (``_atom_site.pdbx_PDB_model_num``,
    1-based), keeps altloc ''/'A' only (matching :func:`read_pdb`),
    prefers author numbering (``auth_*``) so residue ids match what the
    corresponding PDB file would carry, and reads the crystal cell from
    ``_cell`` (converted to the reduced lattice form for non-90
    angles). SEQRES-equivalent per-chain sequences come from
    ``_pdbx_poly_seq_scheme`` (or ``_entity_poly_seq`` as fallback).
    """
    path = Path(path)
    block = _parse_cif(path)
    atom_site = block.loop("_atom_site")
    if atom_site is None:
        raise ValueError(f"no _atom_site loop found in {path}")
    columns, rows = atom_site

    i_group = _col(columns, "group_pdb")
    i_name = _col(columns, "auth_atom_id", "label_atom_id")
    i_res = _col(columns, "auth_comp_id", "label_comp_id")
    i_chain = _col(columns, "auth_asym_id", "label_asym_id")
    i_seq = _col(columns, "auth_seq_id", "label_seq_id")
    i_x = _col(columns, "cartn_x")
    i_y = _col(columns, "cartn_y")
    i_z = _col(columns, "cartn_z")
    i_alt = _col(columns, "label_alt_id")
    i_elem = _col(columns, "type_symbol")
    i_model = _col(columns, "pdbx_pdb_model_num")
    if None in (i_name, i_res, i_x, i_y, i_z):
        raise ValueError(
            f"_atom_site loop in {path} lacks required columns "
            "(atom_id/comp_id/Cartn_x/y/z)"
        )

    residues: List[PDBResidue] = []
    index: Dict[Tuple[str, int, str], PDBResidue] = {}
    models_seen = set()
    # fallback residue grouping for rows with no usable seq id
    # (label_seq_id is '.' for every non-polymer atom per the PDBx
    # spec): consecutive atoms of the same chain+resname stay one
    # residue until an atom name repeats, instead of fragmenting each
    # atom into its own residue
    fb_resid = 0
    fb_key: Tuple[str, str] | None = None
    fb_names: set = set()
    for row in rows:
        if len(row) != len(columns):
            continue  # malformed row
        if i_model is not None and row[i_model] not in _MISSING:
            try:
                m = int(row[i_model])
            except ValueError:
                m = 1
            models_seen.add(m)
            if m != model:
                continue
        if i_alt is not None and row[i_alt] not in _MISSING | {"A"}:
            continue
        if i_group is not None and row[i_group] not in ("ATOM", "HETATM"):
            continue
        name = row[i_name].strip('"')  # e.g. "C1'" quoted in nucleic files
        resname = row[i_res]
        chain = row[i_chain] if i_chain is not None else "A"
        if chain in _MISSING:
            chain = "A"
        if i_seq is not None and row[i_seq] not in _MISSING:
            try:
                resid = int(row[i_seq])
            except ValueError:
                continue
            fb_key = None
        else:
            if fb_key == (chain, resname) and name not in fb_names:
                fb_names.add(name)
            else:
                fb_resid += 1
                fb_key = (chain, resname)
                fb_names = {name}
            resid = fb_resid
        try:
            xyz = (
                float(row[i_x]) / 10.0,
                float(row[i_y]) / 10.0,
                float(row[i_z]) / 10.0,
            )
        except ValueError:
            continue
        element = _guess_element(
            name, row[i_elem] if i_elem is not None else ""
        )
        key = (chain, resid, resname)
        if key not in index:
            res = PDBResidue(name=resname, resid=resid, chain=chain, atoms=[])
            index[key] = res
            residues.append(res)
        index[key].atoms.append(
            PDBAtom(name=name, resname=resname, resid=resid, chain=chain,
                    xyz=xyz, element=element)
        )
    if not residues:
        raise ValueError(f"no atoms found in {path} (model {model})")

    box = tilt = None
    try:
        a = block.scalar("_cell.length_a")
        b = block.scalar("_cell.length_b")
        c = block.scalar("_cell.length_c")
        if a and b and c and a not in _MISSING:
            a, b, c = float(a) / 10.0, float(b) / 10.0, float(c) / 10.0
            al = float(block.scalar("_cell.angle_alpha") or 90.0)
            be = float(block.scalar("_cell.angle_beta") or 90.0)
            ga = float(block.scalar("_cell.angle_gamma") or 90.0)
            if a > 0 and b > 0 and c > 0:
                if max(abs(al - 90), abs(be - 90), abs(ga - 90)) > 1e-3:
                    from ..md.box import from_lengths_angles

                    try:
                        box, tilt = from_lengths_angles(a, b, c, al, be, ga)
                    except ValueError:
                        logger.warning(
                            "_cell in %s is degenerate; ignoring box", path
                        )
                else:
                    box = (a, b, c)
    except ValueError:
        pass

    seqres: Dict[str, List[str]] = {}
    scheme = block.loop("_pdbx_poly_seq_scheme")
    if scheme is not None:
        cols, srows = scheme
        ic = _col(cols, "pdb_strand_id", "asym_id")
        im = _col(cols, "mon_id")
        if ic is not None and im is not None:
            for row in srows:
                if len(row) != len(cols):
                    continue
                seqres.setdefault(row[ic], []).append(row[im])
    else:
        eps = block.loop("_entity_poly_seq")
        if eps is not None:
            cols, srows = eps
            ie = _col(cols, "entity_id")
            im = _col(cols, "mon_id")
            if ie is not None and im is not None:
                by_entity: Dict[str, List[str]] = {}
                for row in srows:
                    if len(row) != len(cols):
                        continue
                    by_entity.setdefault(row[ie], []).append(row[im])
                # without an entity->chain map, assign the single entity
                # to every observed chain (the common monomer case)
                if len(by_entity) == 1:
                    seq = next(iter(by_entity.values()))
                    for ch in sorted({r.chain for r in residues}):
                        seqres[ch] = list(seq)

    return PDBStructure(
        residues=residues,
        n_models=max(len(models_seen), 1),
        box=box,
        tilt=tilt,
        seqres=seqres or None,
    )


def write_cif(path: "str | Path", structure: PDBStructure,
              name: str = "pmarlo") -> Path:
    """Write a :class:`PDBStructure` as a minimal PDBx/mmCIF file
    (``_atom_site`` loop + ``_cell`` when a box is present).

    Unlike fixed-width PDB, mmCIF has no field-width ceilings, so very
    large solvated systems round-trip without hybrid-36 tricks."""
    path = Path(path)
    lines = [f"data_{name}", "#"]
    if structure.box is not None:
        if structure.tilt is not None:
            from ..md.box import to_lengths_angles

            a, b, c, al, be, ga = to_lengths_angles(
                structure.box, structure.tilt
            )
        else:
            a, b, c = structure.box
            al = be = ga = 90.0
        lines += [
            f"_cell.length_a   {a * 10.0:.3f}",
            f"_cell.length_b   {b * 10.0:.3f}",
            f"_cell.length_c   {c * 10.0:.3f}",
            f"_cell.angle_alpha {al:.2f}",
            f"_cell.angle_beta  {be:.2f}",
            f"_cell.angle_gamma {ga:.2f}",
            "#",
        ]
    lines += [
        "loop_",
        "_atom_site.group_PDB",
        "_atom_site.id",
        "_atom_site.type_symbol",
        "_atom_site.label_atom_id",
        "_atom_site.label_comp_id",
        "_atom_site.auth_asym_id",
        "_atom_site.auth_seq_id",
        "_atom_site.Cartn_x",
        "_atom_site.Cartn_y",
        "_atom_site.Cartn_z",
        "_atom_site.pdbx_PDB_model_num",
    ]
    serial = 0
    for res in structure.residues:
        group = "ATOM" if res.name not in _HETEROGENS else "HETATM"
        for atom in res.atoms:
            serial += 1
            aname = f'"{atom.name}"' if "'" in atom.name else atom.name
            lines.append(
                f"{group} {serial} {atom.element} {aname} {res.name} "
                f"{res.chain or 'A'} {res.resid} "
                f"{atom.xyz[0] * 10.0:.3f} {atom.xyz[1] * 10.0:.3f} "
                f"{atom.xyz[2] * 10.0:.3f} 1"
            )
    lines.append("#")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


def read_structure(path: "str | Path", model: int = 1) -> PDBStructure:
    """Format-dispatching structure reader: ``.cif``/``.mmcif`` via
    :func:`read_cif`, everything else via :func:`read_pdb` (reference
    protein.py:137 accepts both suffixes on the Protein constructor)."""
    from .pdb import read_pdb

    p = Path(path)
    if p.suffix.lower() in (".cif", ".mmcif"):
        return read_cif(p, model=model)
    return read_pdb(p, model=model)


__all__ = ["read_cif", "write_cif", "read_structure"]
