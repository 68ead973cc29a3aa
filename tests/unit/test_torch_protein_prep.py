"""Port parity: structure preparation (``protein/``) against the JAX package.

Mirrors of the JAX package's preparation tests (``test_repair.py``,
``test_protein_hydrogens.py``, ``test_descriptors.py``, ``test_npro.py``,
``test_disulfide.py``, ``test_chain_gaps.py``, ``test_ions.py``) run their
checks on the port's modules, with their ``slow`` marks. Where the JAX test
reads a chignolin PDB from a reference checkout, the mirror runs on that
file (and skips as the JAX test does when it is absent) and on the
repository's own chignolin (``data/chignolin.py``).

The parity tests prepare the raw input of ``chip_smoke.py``'s structure
preparation phase (``raw_chignolin_assembly``: no hydrogens or OXT, TYR cut
at CB and TRP at CG, THR 8 phosphorylated, a two-residue gap) in both packages, at
one and at three copies.
"""

import copy
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data.chignolin import chignolin_structure, raw_chignolin_assembly
from pmarlo_tpu_torch.io.pdb import PDBAtom, PDBResidue, PDBStructure, read_pdb
from pmarlo_tpu_torch.md.ff_params import lookup_bond
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.residues import TEMPLATES, get_template
from pmarlo_tpu_torch.protein import Protein
from pmarlo_tpu_torch.protein.hydrogens import add_hydrogens, assign_protonation_states
from pmarlo_tpu_torch.protein.repair import find_missing_heavy_atoms, repair_missing_atoms
from pmarlo_tpu_torch.utils.errors import TopologyError

# the JAX tests' own reference-checkout files, so that the mirrors skip as they do
from test_descriptors import CHIGNOLIN  # noqa: E402
from test_protein_hydrogens import REF_3GD8 as _REF_3GD8  # noqa: E402

REF_3GD8 = Path(_REF_3GD8)

#: System float fields: both packages build them in float64 numpy, cast once
FIELD_RTOL = 1e-6
#: energy and forces of the prepared System against JAX's: max |a - b| over
#: max |b| (both float32 on the CPU, different summation orders)
ENERGY_FORCE_REL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=["reference", "in_repo"])
def chignolin(request):
    """The reference checkout's chignolin (skipped when absent, as the JAX
    tests skip) or the repository's own."""
    if request.param == "reference":
        if not CHIGNOLIN.exists():
            pytest.skip("chignolin test asset not mounted")
        return read_pdb(CHIGNOLIN)
    return chignolin_structure()


def _strip(structure, targets):
    """Remove named atoms from the first residue of each targeted type."""
    s = copy.deepcopy(structure)
    seen = set()
    dropped = 0
    for r in s.residues:
        if r.name in targets and r.name not in seen:
            seen.add(r.name)
            before = len(r.atoms)
            r.atoms = [a for a in r.atoms if a.name.strip() not in targets[r.name]]
            dropped += before - len(r.atoms)
    assert dropped > 0, "strip targets matched nothing"
    return s


def _energy(system, x):
    from pmarlo_tpu_torch.md.forces import potential_energy

    return float(potential_energy(system, torch.as_tensor(x, dtype=torch.float32)))


# --- mirrors of tests/unit/test_repair.py ---------------------------------------------------


def test_find_missing(chignolin):
    assert find_missing_heavy_atoms(chignolin) == {}
    stripped = _strip(chignolin, {"TYR": {"OH", "CZ"}, "THR": {"OG1", "CG2"}})
    miss = find_missing_heavy_atoms(stripped)
    names = {n for v in miss.values() for n in v}
    assert {"OH", "CZ", "OG1", "CG2"} <= names


def test_repair_truncated_side_chains(chignolin):
    stripped = _strip(
        chignolin,
        {"TYR": {"OH", "CZ", "CE1", "CE2"}, "TRP": {"CH2", "CZ2", "CZ3"},
         "GLU": {"OE1", "OE2", "CD"}},
    )
    miss = find_missing_heavy_atoms(stripped)
    repaired = repair_missing_atoms(stripped)
    assert find_missing_heavy_atoms(repaired) == {}
    for (chain, resid, resname), names in miss.items():
        res = next(r for r in repaired.residues if r.chain == chain and r.resid == resid)
        pos = {a.name.strip(): np.asarray(a.xyz) for a in res.atoms}
        tpl = TEMPLATES[resname]
        types = {n: t for n, (t, _q) in tpl["atoms"].items()}
        for a, b in tpl["bonds"]:
            if (a in names or b in names) and a in pos and b in pos:
                d = float(np.linalg.norm(pos[a] - pos[b])) * 10.0
                _, r0 = lookup_bond(types[a], types[b])
                assert r0 * 0.5 < d < r0 * 2.0, (resname, a, b, d, r0)


def test_repair_is_noop_on_complete_structure(chignolin):
    assert repair_missing_atoms(chignolin) is chignolin


@pytest.mark.slow
def test_prepare_with_repair_end_to_end(chignolin):
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    stripped = _strip(chignolin, {"TYR": {"OH", "CZ", "CE1", "CE2"}})
    system, pos = Protein(stripped).prepare().create_system(device="cpu")
    assert math.isfinite(_energy(system, pos))
    _, emin = minimize_energy(system, pos, max_iterations=200)
    assert float(emin) < 0.0


def test_prepare_repair_disabled_fails_fast(chignolin):
    stripped = _strip(chignolin, {"TYR": {"OH"}})
    with pytest.raises(TopologyError):
        Protein(stripped).prepare(add_missing_atoms=False)


def test_unanchorable_residue_raises(chignolin):
    s = copy.deepcopy(chignolin)
    s.residues[3].atoms = [a for a in s.residues[3].atoms if a.name.strip() == "N"]
    with pytest.raises(TopologyError):
        repair_missing_atoms(s)


def _close_gap(s, chain, lo, hi):
    """Take residues lo..hi out of ``chain`` and rebuild them; returns the
    removed names, the rebuilt structure and the closures."""
    from pmarlo_tpu_torch.protein.loops import build_missing_loops

    removed = [r for r in s.residues if r.chain == chain and lo <= r.resid <= hi]
    names = [r.name for r in removed]
    s.residues = [r for r in s.residues if r not in removed]
    key = (chain, lo - 1, hi + 1)
    new_s, closures = build_missing_loops(s, {key: len(names)}, sequences={key: names})
    return names, new_s, closures[key]


def _check_splice(new_s, chain, lo, hi, names):
    rebuilt = {r.resid: r for r in new_s.residues if r.chain == chain and lo <= r.resid <= hi}
    assert sorted(rebuilt) == list(range(lo, hi + 1))
    assert [rebuilt[k].name for k in range(lo, hi + 1)] == names
    by_rid = {r.resid: r for r in new_s.residues if r.chain == chain}
    for rid in range(lo - 1, hi + 1):
        c = next(np.asarray(a.xyz) for a in by_rid[rid].atoms if a.name == "C")
        n = next(np.asarray(a.xyz) for a in by_rid[rid + 1].atoms if a.name == "N")
        assert 0.115 < float(np.linalg.norm(c - n)) < 0.155, rid


def test_ccd_closes_synthetic_gap():
    if not REF_3GD8.exists():
        pytest.skip("3gd8 not mounted")
    names, new_s, closure = _close_gap(read_pdb(REF_3GD8), "A", 60, 62)
    assert closure < 0.05
    _check_splice(new_s, "A", 60, 62, names)


def test_ccd_closes_chignolin_gap():
    """The gap of ``raw_chignolin_assembly`` (TYR 2, ASP 3) closes onto its
    anchors and restores peptide connectivity."""
    names, new_s, closure = _close_gap(chignolin_structure(), "A", 2, 3)
    assert names == ["TYR", "ASP"] and closure < 0.05
    _check_splice(new_s, "A", 2, 3, names)


@pytest.mark.slow
def test_add_missing_residues_end_to_end():
    if not REF_3GD8.exists():
        pytest.skip("3gd8 not mounted")
    s = read_pdb(REF_3GD8)
    s.residues = [r for r in s.residues if not (r.chain == "A" and 60 <= r.resid <= 61)]
    p = Protein(s).prepare()
    closures = p.add_missing_residues()
    assert closures and all(v < 0.02 for v in closures.values())
    p.prepare()
    rebuilt = {r.resid: r for r in p.structure.residues
               if r.chain == "A" and r.resid in (60, 61)}
    assert sorted(rebuilt) == [60, 61]
    for r in rebuilt.values():
        names = {a.name for a in r.atoms}
        assert {"N", "CA", "C", "O"} <= names
        assert any(n.startswith("H") for n in names)
        assert len(names) > 5 or r.name == "GLY"
    system, x = p.create_system(device="cpu")
    assert np.isfinite(_energy(system, x))


def test_ccd_degenerate_anchors_raise():
    from pmarlo_tpu_torch.protein.loops import close_loop_ccd

    p = np.zeros(3)
    with pytest.raises(ValueError, match="degenerate|CCD closure failed"):
        close_loop_ccd((p, p, p), (p + 1.0, p + 1.0, p + 1.0), 2, max_sweeps=10)


# --- mirrors of tests/unit/test_protein_hydrogens.py ----------------------------------------


def test_variant_charge_closure():
    expected = {
        "ASH": 0, "GLH": 0, "LYN": 0, "HIP": 1, "HID": 0, "HIE": 0,
        "ASP": -1, "GLU": -1, "LYS": 1, "ARG": 1, "HIS": 0,
        "NGLY": 1, "CGLY": -1, "NPRO": 1, "NA": 1, "CL": -1,
        "K": 1, "MG": 2, "ZN": 2, "CA": 2,
        "DA": -1, "DC": -1, "DG": -1, "DT": -1, "A": -1, "C": -1, "G": -1, "U": -1,
    }
    for name, tmpl in TEMPLATES.items():
        if name in ("ACE", "NME"):
            continue
        total = sum(q for (_, q) in tmpl["atoms"].values())
        assert abs(total - expected.get(name, 0)) < 5e-4, f"{name}: sum {total}"


def test_terminal_variant_charge_closure():
    for res in ("ALA", "VAL", "SER", "LYS", "ASP"):
        base = sum(q for (_, q) in TEMPLATES[res]["atoms"].values())
        nt = sum(q for (_, q) in get_template(res, is_nterm=True)["atoms"].values())
        ct = sum(q for (_, q) in get_template(res, is_cterm=True)["atoms"].values())
        assert abs(nt - (base + 1)) < 1e-6, f"N{res}"
        assert abs(ct - (base - 1)) < 1e-6, f"C{res}"


def _strip_hydrogens(structure):
    return PDBStructure(
        residues=[PDBResidue(name=r.name, resid=r.resid, chain=r.chain,
                             atoms=[a for a in r.atoms if a.element != "H"])
                  for r in structure.residues],
        n_models=structure.n_models,
    )


def test_add_hydrogens_roundtrip_alanine():
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.md.topology import build_topology

    s = alanine_dipeptide_structure()
    stripped = _strip_hydrogens(s)
    assert stripped.n_atoms < s.n_atoms
    rebuilt = add_hydrogens(stripped)
    assert rebuilt.n_atoms == s.n_atoms
    topo = build_topology(rebuilt)
    system, positions = build_system(topo, device="cpu")
    pos = positions.numpy()
    heavy = [i for i, e in enumerate(topo.elements) if e != "H"]
    for i, e in enumerate(topo.elements):
        if e == "H":
            d = np.linalg.norm(pos[heavy] - pos[i], axis=1)
            assert 0.09 < d.min() < 0.14, f"H {topo.atom_names[i]}: {d.min()}"
    e0 = _energy(system, positions)
    _, emin = minimize_energy(system, positions)
    assert np.isfinite(e0) and float(emin) < e0


def _fake_residue(name, resid=1):
    return PDBResidue(name=name, resid=resid, chain="A",
                      atoms=[PDBAtom("CA", name, resid, "A", (0, 0, 0), "C")])


def test_protonation_state_assignment():
    s = PDBStructure(residues=[_fake_residue("ASP", 1), _fake_residue("GLU", 2),
                               _fake_residue("HIS", 3), _fake_residue("LYS", 4)])
    assert [r.name for r in assign_protonation_states(s, ph=3.0).residues] == [
        "ASH", "GLH", "HIP", "LYS"]
    assert [r.name for r in assign_protonation_states(s, ph=7.0).residues] == [
        "ASP", "GLU", "HIE", "LYS"]
    assert [r.name for r in assign_protonation_states(s, ph=11.5).residues] == [
        "ASP", "GLU", "HIE", "LYN"]
    assert assign_protonation_states(s, ph=7.0, his_variant="HID").residues[2].name == "HID"
    s2 = PDBStructure(residues=[_fake_residue("HIP", 1)])
    assert assign_protonation_states(s2, ph=7.0).residues[0].name == "HIP"


@pytest.mark.slow
def test_3gd8_prepare_end_to_end():
    if not REF_3GD8.exists():
        pytest.skip("reference asset not mounted")
    p = Protein(str(REF_3GD8), ph=7.0).prepare()
    assert p.topology.n_atoms > 3000
    assert sum(1 for e in p.topology.elements if e == "H") > 1500
    system, positions = p.create_system(device="cpu")
    assert np.isfinite(_energy(system, positions))
    q = float(system.charges.double().sum())
    assert abs(q - round(q)) < 1e-3


def test_structural_descriptors_alanine():
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.topology import build_topology
    from pmarlo_tpu_torch.protein.descriptors import compute_descriptors

    d = compute_descriptors(build_topology(alanine_dipeptide_structure()))
    assert d["h_bond_donors"] == 2
    assert d["h_bond_donor_atoms"] == 2
    assert d["h_bond_acceptors"] == 4
    assert d["tpsa"] == pytest.approx(2 * 12.03 + 2 * 17.07, abs=0.01)
    assert d["gravy"] == pytest.approx(1.8)


@pytest.mark.slow
def test_3gd8_extreme_ph_builds():
    if not REF_3GD8.exists():
        pytest.skip("reference asset not mounted")
    for ph, expected in ((3.0, {"ASH", "GLH", "HIP"}), (12.0, {"LYN"})):
        p = Protein(str(REF_3GD8), ph=ph).prepare()
        assert expected <= set(p.topology.residue_sequence), ph
        system, x = p.create_system(device="cpu")
        assert np.isfinite(_energy(system, x))


# --- mirrors of tests/unit/test_descriptors.py ----------------------------------------------


@pytest.fixture(scope="module")
def ala_topo():
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.topology import build_topology

    return build_topology(alanine_dipeptide_structure())


def test_alanine_dipeptide_counts(ala_topo):
    from pmarlo_tpu_torch.protein.descriptors import compute_descriptors

    d = compute_descriptors(ala_topo)
    assert d["heavy_atoms"] == 10
    assert d["aromatic_rings"] == 0
    assert d["rotatable_bonds"] == 2
    assert abs(d["exact_molecular_weight"] - 144.0899) < 0.01


def test_alanine_dipeptide_logp_hand_sum(ala_topo):
    from pmarlo_tpu_torch.protein.descriptors import _CRIPPEN as C
    from pmarlo_tpu_torch.protein.descriptors import compute_logp

    expected = (
        C["C1"] + C["C5"] + C["O9"] + 3 * C["H1"]
        + C["N2"] + C["H3"] + C["C4"] + C["H1"] + C["C1"] + 3 * C["H1"]
        + C["C5"] + C["O9"]
        + C["N2"] + C["H3"] + C["C3"] + 3 * C["H1"]
    )
    assert abs(compute_logp(ala_topo) - expected) < 1e-9


def test_chignolin_descriptors_pinned(chignolin):
    d = Protein(chignolin).prepare().get_properties()
    assert d["aromatic_rings"] == 3
    assert d["heavy_atoms"] == 77
    assert abs(d["logp"] - (-9.786)) < 0.01
    assert d["rotatable_bonds"] == 29
    assert abs(d["exact_molecular_weight"] - 1079.4196) < 0.01
    assert d["exact_molecular_weight"] < d["molecular_weight"]


def _ring_bonds(topo, resnames, pairs=None, ring_names=None):
    from pmarlo_tpu_torch.protein.descriptors import _bond_in_ring

    neighbors = topo.neighbor_sets()
    found = 0
    for a, b in topo.bonds:
        a, b = int(a), int(b)
        na, nb = topo.atom_names[a], topo.atom_names[b]
        if not (topo.residue_names[a] in resnames
                and topo.residue_names[a] == topo.residue_names[b]):
            continue
        if (ring_names is not None and na in ring_names and nb in ring_names) or (
                pairs is not None and {na, nb} in pairs):
            assert _bond_in_ring(a, b, neighbors, topo.residue_ids)
            found += 1
    return found


def test_ring_bonds_not_rotatable(chignolin):
    topo = Protein(chignolin).prepare().topology
    ring = {"CG", "CD1", "CD2", "CE1", "CE2", "CZ", "NE1", "CE3", "CZ2", "CZ3", "CH2"}
    assert _ring_bonds(topo, ("TYR", "TRP"), ring_names=ring) >= 6


def test_proline_ring_not_rotatable(chignolin):
    topo = Protein(chignolin).prepare().topology
    pairs = ({"CB", "CG"}, {"CG", "CD"}, {"N", "CD"})
    assert _ring_bonds(topo, ("PRO",), pairs=pairs) >= 3


def test_cyx_counts_in_sequence_and_mass():
    from pmarlo_tpu_torch.protein.protein import _ONE_LETTER, _RESIDUE_MASS, _canonical

    assert _canonical("CYX") == "CYS"
    assert _canonical("CYM") == "CYS"
    assert _ONE_LETTER[_canonical("CYX")] == "C"
    assert _canonical("CYX") in _RESIDUE_MASS


def test_prepare_ignores_crystallographic_cryst1(tmp_path):
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.io.pdb import write_pdb

    s = alanine_dipeptide_structure()
    pdb = tmp_path / "xray.pdb"
    write_pdb(pdb, s.coordinates(),
              [a.name for r in s.residues for a in r.atoms],
              [a.resname for r in s.residues for a in r.atoms],
              [a.resid for r in s.residues for a in r.atoms],
              box=(5.08, 4.28, 2.90))
    p = Protein(str(pdb))
    p.prepare()
    assert p.box is None


# --- mirrors of tests/unit/test_npro.py -----------------------------------------------------


def test_npro_template_total_charge_is_plus_one():
    tmpl = TEMPLATES["NPRO"]
    assert sum(q for (_, q) in tmpl["atoms"].values()) == pytest.approx(1.0, abs=1e-9)
    n_h = [b for b in tmpl["bonds"] if "N" in b and any(x.startswith("H") for x in b)]
    assert len(n_h) == 2
    assert "H1" not in tmpl["atoms"]


def test_get_template_nterm_pro_no_longer_raises():
    tmpl = get_template("PRO", is_nterm=True)
    assert tmpl is TEMPLATES["NPRO"]
    assert tmpl["head"] is None


def test_pro_initial_chain_prepares_and_builds(chignolin):
    names = [r.name for r in chignolin.residues]
    start = names.index("PRO")
    trunc = PDBStructure(residues=copy.deepcopy(chignolin.residues[start:]),
                         n_models=chignolin.n_models)
    for r in trunc.residues:
        r.atoms = [a for a in r.atoms if not a.element.startswith("H")]
    p = Protein(trunc).prepare()
    first = p.structure.residues[0]
    assert first.name == "PRO"
    hs = {a.name for a in first.atoms if a.name.startswith("H")}
    assert {"H2", "H3"} <= hs and "H1" not in hs
    system, positions = p.create_system(device="cpu")
    assert np.isfinite(_energy(system, positions))
    assert p.get_properties()["formal_charge"] == int(round(float(system.charges.double().sum())))


# --- mirrors of tests/unit/test_disulfide.py ------------------------------------------------


def _cys_peptide(chain, offset, sg_pos):
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure

    residues = []
    for res in alanine_dipeptide_structure().residues:
        name = "CYS" if res.name == "ALA" else res.name
        atoms = [PDBAtom(a.name, name, a.resid, chain, tuple(np.asarray(a.xyz) + offset),
                         a.element) for a in res.atoms if a.element != "H"]
        if name == "CYS":
            atoms.append(PDBAtom("SG", name, res.resid, chain, tuple(sg_pos), "S"))
        residues.append(PDBResidue(name=name, resid=res.resid, chain=chain, atoms=atoms))
    return residues


@pytest.fixture()
def disulfide_structure():
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure

    src = alanine_dipeptide_structure()
    cb, ca = (next(np.asarray(a.xyz) for r in src.residues for a in r.atoms
                   if r.name == "ALA" and a.name == n) for n in ("CB", "CA"))
    u0 = (cb - ca) / np.linalg.norm(cb - ca)
    perp = np.cross(u0, [0.0, 0.0, 1.0])
    perp /= np.linalg.norm(perp)
    u = u0 * np.cos(np.radians(70)) + perp * np.sin(np.radians(70))
    sg_a = cb + 0.181 * u
    sg_b = sg_a + 0.205 * u
    mid = 0.5 * (sg_a + sg_b)
    res_b = [PDBResidue(res.name, res.resid, "B", [
        PDBAtom(a.name, a.resname, a.resid, "B", tuple(2 * mid - np.asarray(a.xyz)), a.element)
        for a in res.atoms]) for res in _cys_peptide("B", np.zeros(3), sg_a)]
    return PDBStructure(residues=_cys_peptide("A", np.zeros(3), sg_a) + res_b)


@pytest.mark.slow
def test_disulfide_detection_and_build(disulfide_structure):
    p = Protein(disulfide_structure).prepare()
    names = set(p.topology.residue_sequence)
    assert "CYX" in names and "CYS" not in names
    sg = [i for i, n in enumerate(p.topology.atom_names) if n == "SG"]
    assert len(sg) == 2
    assert tuple(sorted(sg)) in {tuple(sorted(b)) for b in p.topology.bonds.tolist()}
    assert "HG" not in p.topology.atom_names
    system, positions = p.create_system(device="cpu")
    assert np.isfinite(_energy(system, positions))
    q = float(system.charges.double().sum())
    assert abs(q - round(q)) < 1e-3


def test_free_cysteines_stay_cys():
    from pmarlo_tpu_torch.protein.hydrogens import _assign_disulfides

    def one(chain, shift):
        return PDBResidue(name="CYS", resid=1, chain=chain,
                          atoms=[PDBAtom("SG", "CYS", 1, chain, (shift, 0.0, 0.0), "S")])

    out = _assign_disulfides(PDBStructure(residues=[one("A", 0.0), one("B", 1.0)]))
    assert [r.name for r in out.residues] == ["CYS", "CYS"]


# --- mirrors of tests/unit/test_chain_gaps.py -----------------------------------------------


def _with_gap(structure, drop_index):
    s = copy.deepcopy(structure)
    del s.residues[drop_index]
    return s


def test_gap_detected(chignolin):
    p = Protein(_with_gap(chignolin, 4)).prepare()
    gaps = p.find_missing_residues()
    assert len(gaps) == 1
    (chain, before, after), n = next(iter(gaps.items()))
    assert after - before == 2 and n == 1


def test_gap_not_bonded_across(chignolin):
    topo = Protein(_with_gap(chignolin, 4)).prepare().topology
    pos = np.asarray(topo.positions)
    for a, b in topo.bonds:
        d = float(np.linalg.norm(pos[int(a)] - pos[int(b)])) * 10.0
        assert d < 2.5, (topo.atom_names[int(a)], topo.atom_names[int(b)], d)


@pytest.mark.slow
def test_gap_fragments_have_finite_energy(chignolin):
    system, x = Protein(_with_gap(chignolin, 4)).prepare().create_system(device="cpu")
    e = _energy(system, x)
    assert np.isfinite(e) and e < 1e4


def test_intact_structure_reports_no_gaps(chignolin):
    assert Protein(chignolin).prepare().find_missing_residues() == {}


# --- mirrors of tests/unit/test_ions.py -----------------------------------------------------

ION_CHARGES = {"NA": 1.0, "K": 1.0, "CL": -1.0, "MG": 2.0, "CA": 2.0, "ZN": 2.0}


def test_ion_templates_register():
    from pmarlo_tpu_torch.md.ff_params import TYPE_ELEMENTS, TYPE_LJ, TYPE_MASSES
    from pmarlo_tpu_torch.md.residues import NONPOLYMER

    for resname, q in ION_CHARGES.items():
        assert resname in TEMPLATES and resname in NONPOLYMER
        atoms = TEMPLATES[resname]["atoms"]
        assert len(atoms) == 1
        (atype, charge), = atoms.values()
        assert charge == q
        assert atype in TYPE_LJ and atype in TYPE_MASSES
        assert TYPE_ELEMENTS[atype] != "H"


def _ion(resname, resid, xyz):
    name = next(iter(TEMPLATES[resname]["atoms"]))
    return PDBResidue(name=resname, resid=resid, chain="I", atoms=[
        PDBAtom(name=name, resname=resname, resid=resid, chain="I", xyz=tuple(xyz),
                element=resname[0] + resname[1:].lower())])


def _water(resid, origin):
    o = np.asarray(origin, float)
    sites = (("O", o, "O"), ("H1", o + np.array([0.09572, 0.0, 0.0]), "H"),
             ("H2", o + np.array([-0.02399, 0.09268, 0.0]), "H"))
    return PDBResidue(name="HOH", resid=resid, chain="W", atoms=[
        PDBAtom(name=n, resname="HOH", resid=resid, chain="W", xyz=tuple(p), element=e)
        for n, p, e in sites])


def test_mixed_ion_box_forces_match_finite_differences():
    from pmarlo_tpu_torch.md.forces import compute_forces

    residues = [
        _ion("MG", 1, (0.30, 0.30, 0.30)), _ion("K", 2, (1.10, 0.40, 0.40)),
        _ion("CA", 3, (0.40, 1.10, 0.45)), _ion("ZN", 4, (1.05, 1.05, 1.05)),
        _ion("CL", 5, (0.45, 0.45, 1.10)), _ion("CL", 6, (1.10, 0.45, 1.05)),
        _ion("CL", 7, (0.45, 1.05, 1.05)), _ion("CL", 8, (0.75, 0.75, 0.20)),
        _ion("CL", 9, (0.20, 0.75, 0.75)), _ion("CL", 10, (0.75, 0.20, 0.75)),
        _water(11, (0.75, 0.75, 0.75)), _water(12, (0.30, 0.75, 0.30)),
    ]
    system, x0 = build_system(PDBStructure(residues=residues), box=(1.5, 1.5, 1.5),
                              cutoff=0.7, hydrogen_mass=None, device="cpu")
    assert abs(float(system.charges.double().sum()) - 1.0) < 1e-4
    pos = x0.double().numpy()
    analytic = compute_forces(system, torch.as_tensor(pos, dtype=torch.float32)).numpy()
    assert np.isfinite(analytic).all()
    eps, errs = 1e-4, []
    scale = max(np.abs(analytic).max(), 1.0)
    for i in range(system.n_atoms):
        for d in range(3):
            p = pos.copy(); p[i, d] += eps
            m = pos.copy(); m[i, d] -= eps
            errs.append(abs(-(_energy(system, p) - _energy(system, m)) / (2 * eps)
                            - analytic[i, d]))
    assert max(errs) / scale < 1e-2


def test_implicit_path_strips_ions():
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure

    prot = alanine_dipeptide_structure()
    with_ions = PDBStructure(residues=list(prot.residues) + [
        _ion("MG", 100, (2.3, 0.3, 0.3)), _ion("CL", 101, (2.8, 0.3, 0.3)),
        _ion("CL", 102, (2.3, 0.8, 0.3))])
    system, _ = build_system(with_ions, gb_model="gbn2", hydrogen_mass=None, device="cpu")
    bare, _ = build_system(prot, gb_model="gbn2", hydrogen_mass=None, device="cpu")
    assert system.n_atoms == bare.n_atoms


# --- the raw assembly of chip_smoke.py's preparation phase, in both packages ----------------


def _to_jax(structure):
    from pmarlo_tpu.io import pdb as jpdb

    return jpdb.PDBStructure(residues=[
        jpdb.PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
            jpdb.PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                         xyz=a.xyz, element=a.element) for a in r.atoms])
        for r in structure.residues])


def _atoms(structure):
    return [(r.name, r.resid, r.chain, a.name, a.resname, a.resid, a.chain,
             tuple(a.xyz), a.element) for r in structure.residues for a in r.atoms]


COPIES = {"monomer": (1, 1, 1), "three": (3, 1, 1)}


@pytest.fixture(scope="module", params=sorted(COPIES))
def prepared(request):
    """(port Protein, JAX Protein, closures of each, raw input, gap) after
    prepare -> add_missing_residues -> prepare."""
    from pmarlo_tpu.protein.protein import Protein as JaxProtein

    raw, gap = raw_chignolin_assembly(COPIES[request.param])
    port, ref = Protein(raw, ph=7.0), JaxProtein(_to_jax(raw), ph=7.0)
    out = {"copies": COPIES[request.param], "raw": raw, "gap": gap, "first": []}
    for p in (port, ref):
        p.prepare()
        out["first"].append(_atoms(p.structure))
    out["closures"] = [p.add_missing_residues(sequences=gap) for p in (port, ref)]
    for p in (port, ref):
        p.prepare()
    out["port"], out["jax"] = port, ref
    return out


def test_prepare_matches_jax_bit_for_bit(prepared):
    port, ref = prepared["port"], prepared["jax"]
    assert prepared["first"][0] == prepared["first"][1]
    assert _atoms(port.structure) == _atoms(ref.structure)
    pt, jt = port.topology, ref.topology
    assert list(pt.atom_names) == list(jt.atom_names)
    assert list(pt.residue_names) == list(jt.residue_names)
    assert list(pt.atom_types) == list(jt.atom_types)
    np.testing.assert_array_equal(pt.positions, jt.positions)
    np.testing.assert_array_equal(pt.charges, jt.charges)
    np.testing.assert_array_equal(pt.bonds, jt.bonds)


def test_properties_and_closures_match_jax(prepared):
    assert prepared["closures"][0] == prepared["closures"][1]
    assert prepared["port"].get_properties() == prepared["jax"].get_properties()


def test_prepared_assembly_is_the_reference(prepared):
    """The prepared raw input has the assembly's residues, atom names and
    order (protonation variants included) and formal charge; every heavy
    atom of the raw input keeps its position bit for bit."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.md.topology import build_topology

    ref = build_topology(chignolin_assembly(prepared["copies"]))
    top = prepared["port"].topology
    assert list(top.atom_names) == list(ref.atom_names)
    assert list(top.residue_names) == list(ref.residue_names)
    assert list(top.chain_ids) == list(ref.chain_ids)
    assert round(float(top.charges.sum())) == round(float(ref.charges.sum()))
    got = {(a.chain, a.resid, a.name): a.xyz
           for r in prepared["port"].structure.residues for a in r.atoms}
    phosphate = ("P", "O1P", "O2P", "O3P")
    raw = [a for r in prepared["raw"].residues for a in r.atoms if a.name not in phosphate]
    assert all(got[(a.chain, a.resid, a.name)] == a.xyz for a in raw)
    assert all(v < 3 * 0.005 for v in prepared["closures"][0].values())


def test_create_system_matches_jax(prepared):
    import jax.numpy as jnp

    from pmarlo_tpu.md.integrate import make_force_fn as jax_make_force_fn
    from pmarlo_tpu_torch.md.integrate import make_force_fn

    ts, tx = prepared["port"].create_system(hydrogen_mass=3.0, device="cpu")
    js, jx = prepared["jax"].create_system(hydrogen_mass=3.0)
    assert ts.device == torch.device("cpu")
    jd, td = js.to_dict(), ts.to_dict()
    assert set(jd) == set(td)
    for key, a in jd.items():
        if isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(td[key], a, rtol=FIELD_RTOL, atol=0.0, err_msg=key)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(td[key], a, err_msg=key)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=FIELD_RTOL, atol=0.0)
    e, f = make_force_fn(ts)(tx)
    je, jf = (np.asarray(v, np.float64) for v in jax_make_force_fn(js)(jnp.asarray(jx)))
    assert abs(float(e) - je) / abs(je) <= ENERGY_FORCE_REL
    assert np.abs(f.numpy() - jf).max() / np.abs(jf).max() <= ENERGY_FORCE_REL


def test_protein_tables_are_jax_tables():
    """The sequence tables of ``protein/protein.py`` are JAX's."""
    from pmarlo_tpu.protein import protein as jax_protein
    from pmarlo_tpu_torch.protein import protein as port_protein

    for name in ("_RESIDUE_MASS", "_PKA_SIDECHAIN", "_PKA_NTERM", "_PKA_CTERM",
                 "_HYDROPHOBIC", "_AROMATIC", "_ONE_LETTER", "_WATER_NAMES", "_CANONICAL"):
        assert getattr(port_protein, name) == getattr(jax_protein, name), name


def test_protein_exports_are_jax_exports():
    import pmarlo_tpu.protein as jax_pkg
    import pmarlo_tpu_torch.protein as port_pkg

    public = {n for n in dir(jax_pkg) if not n.startswith("_")
              and type(getattr(jax_pkg, n)).__name__ != "module"}
    assert public <= set(dir(port_pkg))
    assert set(port_pkg.__all__) == public
