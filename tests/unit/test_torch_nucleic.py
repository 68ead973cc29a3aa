"""Port parity: DNA and RNA strands (``data/dna.py``) through the port's
preparation and force field, against the JAX package.

The mirrors of ``tests/unit/test_dna.py`` and ``tests/unit/test_rna.py``
run their checks on the port's modules (their ``slow`` marks kept); the
parity tests hold the strands equal to JAX's bit for bit, and a
protein-nucleic complex (the first chain of the prepared, stripped
chignolin assembly beside a 4-mer, offset as in
``examples/23_protein_dna_complex.py``) to JAX's System, energy and forces.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu.data.dna import dna_single_strand as jax_dna
from pmarlo_tpu.data.dna import rna_single_strand as jax_rna
from pmarlo_tpu_torch.data.chignolin import shifted_residues
from pmarlo_tpu_torch.data.dna import dna_single_strand, rna_single_strand
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.nucleic import (
    DNA_RESIDUES,
    NUCLEIC_RESIDUES,
    RNA_RESIDUES,
)
from pmarlo_tpu_torch.md.residues import (
    NUCLEIC_RESNAMES,
    TEMPLATES,
    get_template,
    normalize_atom_name,
)
from pmarlo_tpu_torch.protein.hydrogens import add_hydrogens

#: energy and forces of the complex against JAX's: max |a - b| over max |b|
#: (both float32 on the CPU, different summation orders)
ENERGY_FORCE_REL = 1e-4
#: System float fields: both packages build them in float64 numpy and cast once
FIELD_RTOL = 1e-6
#: the strand's total charge: three phosphates, -3 e (the templates' sums
#: close to 1e-6 a residue; float32 charges)
CHARGE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _atoms(structure):
    return [(r.name, r.resid, r.chain, a.name, a.resname, a.resid, a.chain,
             tuple(a.xyz), a.element) for r in structure.residues for a in r.atoms]


def _system(structure):
    return build_system(add_hydrogens(structure, ph=7.0), gb_model="gbn2", device="cpu")


def _fd_errors(system, x0, seed=0):
    """Max |central difference - analytic| over max |F| for 12 random atoms,
    0.004 nm off the FIRE minimum (the JAX tests' protocol)."""
    from pmarlo_tpu_torch.md.forces import compute_forces, potential_energy
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    xmin, _ = minimize_energy(system, x0, max_iterations=300)
    rng = np.random.default_rng(seed)
    pos = xmin.double().numpy() + rng.normal(0.0, 0.004, tuple(xmin.shape))
    analytic = compute_forces(system, torch.as_tensor(pos, dtype=torch.float32)).numpy()
    eps = 1e-4
    idx = rng.choice(system.n_atoms, size=12, replace=False)
    errs = []
    scale = max(np.abs(analytic).max(), 1.0)
    for i in idx:
        for d in range(3):
            p = pos.copy(); p[i, d] += eps
            m = pos.copy(); m[i, d] -= eps
            fd = -(float(potential_energy(system, torch.as_tensor(p, dtype=torch.float32)))
                   - float(potential_energy(system, torch.as_tensor(m, dtype=torch.float32)))
                   ) / (2 * eps)
            errs.append(abs(fd - analytic[i, d]))
    return max(errs) / scale


def _segment_temperature(system, x0, steps=10_000, seed=0):
    from pmarlo_tpu_torch.md.integrate import run_md, thermalize
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    xmin, _ = minimize_energy(system, x0, max_iterations=2000)
    gen = torch.Generator().manual_seed(seed)
    st = thermalize(system, xmin, gen, 300.0)
    final, frames = run_md(system, st, n_steps=steps, dt=0.001, friction=1.0,
                           temperature_K=300.0, report_interval=1000)
    assert torch.isfinite(final.positions).all()
    return frames["temperature"].numpy()


# --- mirrors of tests/unit/test_dna.py -----------------------------------------------------


def test_dna_template_charge_sums():
    for r in DNA_RESIDUES:
        internal = sum(q for _, q in TEMPLATES[r]["atoms"].values())
        five = sum(q for _, q in get_template(r, is_nterm=True)["atoms"].values())
        three = sum(q for _, q in get_template(r, is_cterm=True)["atoms"].values())
        both = sum(q for _, q in get_template(
            r, is_nterm=True, is_cterm=True)["atoms"].values())
        assert abs(internal - (-1.0)) < 1e-6, r
        assert abs(five - (-0.3079)) < 1e-6, r
        assert abs(three - (-0.6921)) < 1e-6, r
        assert abs(five + three - (-1.0)) < 1e-6, r
        assert abs(both) < 1e-6, r


def test_nucleic_name_normalization():
    assert normalize_atom_name("O5*") == "O5'"
    assert normalize_atom_name("1H5'") == "H5'"
    assert normalize_atom_name("2H5'") == "H5''"
    assert normalize_atom_name("2H2'") == "H2''"
    assert normalize_atom_name("O1P") == "OP1"
    assert normalize_atom_name("O2", "ALA") == "OXT"
    assert normalize_atom_name("O2", "DT") == "O2"


@pytest.fixture(scope="module")
def dna_system():
    return _system(dna_single_strand("GATC"))


@pytest.fixture(scope="module")
def rna_system():
    return _system(rna_single_strand("GACU"))


def test_dna_strand_builds_with_integer_charge(dna_system):
    system, x0 = dna_system
    assert system.n_atoms == 126
    assert abs(float(system.charges.double().sum()) + 3.0) < CHARGE_ATOL


def test_dna_forces_match_finite_differences(dna_system):
    assert _fd_errors(*dna_system) < 1e-2


@pytest.mark.slow
def test_dna_segment_stable(dna_system):
    T = _segment_temperature(*dna_system)
    assert 150.0 < float(T[-3:].mean()) < 450.0


@pytest.mark.slow
def test_protein_dna_complex_builds_and_runs():
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.io.pdb import PDBStructure

    combo = PDBStructure(residues=list(alanine_dipeptide_structure().residues)
                         + shifted_residues(dna_single_strand("GA", chain="X").residues))
    system, x0 = _system(combo)
    assert abs(float(system.charges.double().sum()) + 1.0) < CHARGE_ATOL
    T = _segment_temperature(system, x0, steps=5_000, seed=1)
    assert 150.0 < float(T[-2:].mean()) < 450.0


# --- mirrors of tests/unit/test_rna.py -----------------------------------------------------


def test_resname_sets_agree():
    assert NUCLEIC_RESNAMES == frozenset(NUCLEIC_RESIDUES)


def test_rna_template_charge_sums():
    for r in RNA_RESIDUES:
        internal = sum(q for _, q in TEMPLATES[r]["atoms"].values())
        five = sum(q for _, q in get_template(r, is_nterm=True)["atoms"].values())
        three = sum(q for _, q in get_template(r, is_cterm=True)["atoms"].values())
        both = sum(q for _, q in get_template(
            r, is_nterm=True, is_cterm=True)["atoms"].values())
        assert abs(internal - (-1.0)) < 1e-6, r
        assert abs(five - (-0.3081)) < 1e-6, r
        assert abs(three - (-0.6919)) < 1e-6, r
        assert abs(five + three - (-1.0)) < 1e-6, r
        assert abs(both) < 1e-6, r


def test_ribose_has_2prime_hydroxyl():
    for r in RNA_RESIDUES:
        atoms = TEMPLATES[r]["atoms"]
        assert atoms["O2'"][0] == "OH" and atoms["HO2'"][0] == "HO", r
        assert "H2''" not in atoms, r
        bonds = {frozenset(b) for b in TEMPLATES[r]["bonds"]}
        assert frozenset(("C2'", "O2'")) in bonds, r
        assert frozenset(("O2'", "HO2'")) in bonds, r


def test_rna_name_normalization():
    assert normalize_atom_name("O2*") == "O2'"
    assert normalize_atom_name("HO2'") == "HO2'"
    assert normalize_atom_name("O2", "U") == "O2"
    assert normalize_atom_name("O2", "C") == "O2"
    assert normalize_atom_name("O1P", "A") == "OP1"


def test_rna_strand_builds_with_integer_charge(rna_system):
    system, x0 = rna_system
    expected = sum(
        len(get_template(r, is_nterm=(i == 0), is_cterm=(i == 3))["atoms"])
        for i, r in enumerate(("G", "A", "C", "U")))
    assert system.n_atoms == expected == 127
    assert abs(float(system.charges.double().sum()) + 3.0) < CHARGE_ATOL


def test_rna_forces_match_finite_differences(rna_system):
    assert _fd_errors(*rna_system) < 1e-2


@pytest.mark.slow
def test_rna_segment_stable(rna_system):
    T = _segment_temperature(*rna_system)
    assert 150.0 < float(T[-3:].mean()) < 450.0


def test_featurize_mixed_protein_rna_complex():
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.features.base import TopologyInfo
    from pmarlo_tpu_torch.features.featurize import featurize_trajectory
    from pmarlo_tpu_torch.io.pdb import PDBStructure
    from pmarlo_tpu_torch.md.topology import build_topology

    combo = add_hydrogens(PDBStructure(
        residues=list(alanine_dipeptide_structure().residues)
        + shifted_residues(rna_single_strand("GA", chain="X").residues)), ph=7.0)
    top = TopologyInfo.from_topology(build_topology(combo))
    _, x0 = build_system(combo, gb_model="gbn2", device="cpu")
    traj = x0.numpy()[None].repeat(2, axis=0)
    X, _ = featurize_trajectory(traj, "phi_psi", top, device="cpu")
    assert tuple(X.shape) == (2, 2)
    for spec in ("rg", "sasa", "ssfrac"):
        X, _ = featurize_trajectory(traj, spec, top, device="cpu")
        assert torch.isfinite(torch.as_tensor(X)).all(), spec


# --- parity with the JAX package ------------------------------------------------------------


@pytest.mark.parametrize("kind, seq", [("dna", "GATC"), ("dna", "A"), ("dna", "GATTACA"),
                                       ("rna", "GACU"), ("rna", "U"), ("rna", "GGCAUU")])
def test_strands_equal_jax_bit_for_bit(kind, seq):
    port, ref = ((dna_single_strand, jax_dna) if kind == "dna"
                 else (rna_single_strand, jax_rna))
    assert _atoms(port(seq, chain="X")) == _atoms(ref(seq, chain="X"))


@pytest.fixture(scope="module")
def prepared_chain():
    """Chain A of the prepared stripped 1-copy assembly (138 atoms)."""
    from pmarlo_tpu_torch.data.chignolin import raw_chignolin_assembly
    from pmarlo_tpu_torch.protein import Protein

    raw, gap = raw_chignolin_assembly((1, 1, 1))
    p = Protein(raw, ph=7.0).prepare()
    p.add_missing_residues(sequences=gap)
    p.prepare()
    return [r for r in p.structure.residues if r.chain == "A"]


@pytest.mark.parametrize("kind", ["dna", "rna"])
def test_protein_nucleic_complex_matches_jax(kind, prepared_chain):
    import jax.numpy as jnp

    from pmarlo_tpu.io.pdb import PDBStructure as JaxStructure
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu.md.integrate import make_force_fn as jax_make_force_fn
    from pmarlo_tpu.protein.hydrogens import add_hydrogens as jax_add_hydrogens
    from pmarlo_tpu_torch.io.pdb import PDBStructure
    from pmarlo_tpu_torch.md.integrate import make_force_fn
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    strand = (dna_single_strand if kind == "dna" else rna_single_strand)(
        "GATC" if kind == "dna" else "GACU", chain="X")
    residues = list(prepared_chain) + shifted_residues(strand.residues)
    port_h = add_hydrogens(PDBStructure(residues=residues), ph=7.0)
    jax_h = jax_add_hydrogens(JaxStructure(residues=residues), ph=7.0)
    assert _atoms(port_h) == _atoms(jax_h)
    ts, tx = build_system(port_h, gb_model="gbn2", device="cpu")
    js, jx = jax_build_system(jax_h, gb_model="gbn2")
    assert ts.n_atoms == js.n_atoms < 512
    jd, td = js.to_dict(), ts.to_dict()
    assert set(jd) == set(td)
    for key, a in jd.items():
        if isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(td[key], a, rtol=FIELD_RTOL, atol=0.0, err_msg=key)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(td[key], a, err_msg=key)
    protein, _ = build_system(PDBStructure(residues=list(prepared_chain)),
                              gb_model="gbn2", device="cpu")
    dq = float(ts.charges.double().sum()) - float(protein.charges.double().sum())
    assert abs(dq + 3.0) < CHARGE_ATOL
    # the dense analytic evaluation (the MD path's) of both packages, at the
    # built positions and 0.004 nm off the point 200 FIRE iterations reach
    # (the JAX tests' finite-difference protocol: at a minimum the forces are
    # a residual of cancelling terms, and float32 summation order alone moves
    # them by ~1e-4 of their max)
    port_fn, jax_fn = make_force_fn(ts), jax_make_force_fn(js)
    xmin, _ = minimize_energy(ts, tx, max_iterations=200, force_fn=port_fn)
    rng = np.random.default_rng(0)
    xoff = xmin + torch.as_tensor(rng.normal(0.0, 0.004, tuple(xmin.shape)), dtype=torch.float32)
    for x in (tx, xoff):
        e, f = port_fn(x)
        je, jf = (np.asarray(v, np.float64) for v in jax_fn(jnp.asarray(x.numpy())))
        assert abs(float(e) - je) / abs(je) <= ENERGY_FORCE_REL
        assert np.abs(f.numpy() - jf).max() / np.abs(jf).max() <= ENERGY_FORCE_REL
