"""The yardstick: the frozen roofline arithmetic and the plain reference,
held on the CPU against published values, against the port and against the
JAX package (the tests may import them, the latter in a process of its
own; the reference imports neither)."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO

sys.path.insert(0, str(REPO))

from portbench.reference.md import Reference, ladder, step_noise, swap_uniforms  # noqa: E402
from portbench.reference.neck import neck_maximum  # noqa: E402
from portbench.reference.params import system_params  # noqa: E402
from portbench.roofline import md_bound  # noqa: E402

INPUTS = ["alanine-dipeptide.pdb", "chignolin.pdb"]
MODELS = ["obc2", "gbn2"]
CASES = [(pdb, model) for pdb in INPUTS for model in MODELS]

#: entries of the published GBn2 neck tables (Amber's igb=8, OpenMM's
#: GBn2): (atom's offset radius, partner's; nm) -> (d0 nm, m0 1/nm), from
#: the tables in Angstrom and 1/Angstrom to their six digits
PUBLISHED_NECK = {
    (0.100, 0.100): (0.226685, 0.381511), (0.100, 0.105): (0.231191, 0.396198),
    (0.105, 0.100): (0.232548, 0.338587), (0.110, 0.100): (0.238397, 0.301776),
    (0.115, 0.100): (0.244235, 0.270030), (0.120, 0.100): (0.250057, 0.242506),
    (0.200, 0.100): (0.341360, 0.0614589),
}


@pytest.mark.parametrize("n_atoms,bound_ms", [(22, 0.00292), (138, 0.119)])
def test_roofline_gives_row_1s_bounds(n_atoms, bound_ms):
    """100 steps at R = 32: 101 force evaluations (the energies at the last
    positions too), as the port's kernel table counts them."""
    b = md_bound(32, n_atoms, 101)
    assert b["bound_by"] == "operations"
    assert abs(b["bound_ms"] - bound_ms) / bound_ms < 0.005


@pytest.mark.parametrize("pair", sorted(PUBLISHED_NECK), ids=lambda p: f"{p[0]}-{p[1]}")
def test_neck_reproduces_the_published_tables(pair):
    """The neck worked out from its definition gives the published d0 / m0
    to their last digit, the table's orientation included: an atom's entry
    against a smaller partner is not the partner's against it."""
    d0, m0 = neck_maximum(*pair)
    want_d0, want_m0 = PUBLISHED_NECK[pair]
    assert abs(d0 / want_d0 - 1.0) < 1e-5
    assert abs(m0 / want_m0 - 1.0) < 1e-5


def _port(pdb, model):
    from pmarlo_tpu_torch.io.pdb import read_pdb
    from pmarlo_tpu_torch.md.forcefield import build_system

    return build_system(read_pdb(REPO / "portbench/inputs" / pdb), gb_model=model,
                        device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("pdb,model", CASES)
def test_parameters_equal_the_ports_build(pdb, model):
    """The frozen tables give the port's parameters (the neck's d0 / m0
    excepted: the reference works them out, the port reads its own table)."""
    p = system_params(REPO / "portbench/inputs" / pdb, 3.0, model)
    s, x = _port(pdb, model)
    pairs = {"masses": s.masses, "charges": s.charges, "bond_k": s.bond_k,
             "angle_k": s.angle_k, "tors_k": s.torsion_k, "tors_phase": s.torsion_phase,
             "sigma": s.lj_sigma, "eps": s.lj_eps, "scale_e": s.scale_elec,
             "gb_radii": s.gb_radii, "gb_screen": s.gb_screen, "positions": x}
    for k, v in pairs.items():
        np.testing.assert_allclose(p[k], v.numpy(), rtol=0, atol=1e-12, err_msg=k)
    assert np.array_equal(p["tors_idx"], s.torsion_idx.numpy())
    assert p["gb_offset"] == pytest.approx(s.gb_offset, abs=1e-12)
    assert p["gb_neck_scale"] == pytest.approx(s.gb_neck_scale, abs=1e-12)


def _positions(x, seed=3):
    g = torch.Generator().manual_seed(seed)
    return x[None] + 0.01 * torch.randn((2,) + tuple(x.shape), generator=g, dtype=torch.float64)


@pytest.mark.parametrize("pdb,model", CASES)
def test_energy_and_forces_equal_the_ports_autograd(pdb, model):
    """The port's energy, under GBn2 with the reference's neck tables put in
    its place, so that every other term is held."""
    from pmarlo_tpu_torch.md.forces import energy_and_forces_autograd

    ref = Reference(system_params(REPO / "portbench/inputs" / pdb, 3.0, model))
    s, x = _port(pdb, model)
    if model == "gbn2":
        s = dataclasses.replace(s, gb_neck_d0=ref.d0, gb_neck_m0=ref.m0)
    xs = _positions(x)
    e1, f1 = ref.energy_and_forces(xs)
    e2, f2 = energy_and_forces_autograd(s, xs)
    assert float((e1 - e2).abs().max()) < 1e-4
    assert float((f1 - f2).abs().max() / f2.abs().max()) < 1e-7


_JAX_ENERGY = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from pmarlo_tpu.md.forcefield import build_system
from pmarlo_tpu.md.forces import potential_energy
pdb, model, frames, tables = sys.argv[1:5]
s, _ = build_system(pdb, gb_model=model, dtype=jnp.float64)
if model == "gbn2":
    t = np.load(tables)
    s = dataclasses.replace(s, gb_neck_d0=jnp.asarray(t["d0"]), gb_neck_m0=jnp.asarray(t["m0"]))
x = np.load(frames)
print(json.dumps([float(potential_energy(s, jnp.asarray(f))) for f in x]))
"""


@pytest.mark.parametrize("pdb,model", CASES)
def test_energy_equals_the_jax_packages(pdb, model, tmp_path):
    """A second witness that is not the port's build: the JAX package's
    energy on the CPU in float64 (under GBn2 with the reference's neck
    tables), in a process of its own."""
    if importlib.util.find_spec("jax") is None:     # looked for, not loaded here
        pytest.skip("the JAX package's witness needs jax")
    ref = Reference(system_params(REPO / "portbench/inputs" / pdb, 3.0, model))
    x = torch.as_tensor(system_params(REPO / "portbench/inputs" / pdb, 3.0, model)["positions"])
    xs = _positions(x, seed=5)
    np.save(tmp_path / "x.npy", xs.numpy())
    if model == "gbn2":
        np.savez(tmp_path / "t.npz", d0=ref.d0.numpy(), m0=ref.m0.numpy())
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1", PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", _JAX_ENERGY, str(REPO / "portbench/inputs" / pdb),
                        model, str(tmp_path / "x.npy"), str(tmp_path / "t.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    jax_e = np.asarray(json.loads(p.stdout.strip().splitlines()[-1]))
    assert np.abs(ref.energy(xs).numpy() - jax_e).max() < 1e-4


def test_noise_and_uniforms_equal_the_ports_streams():
    from pmarlo_tpu_torch.md.integrate import gaussian_noise
    from pmarlo_tpu_torch.remd.remd import swap_uniforms as port_uniforms

    seeds = torch.tensor([12345, 2**31 - 2, 7, 99], dtype=torch.int32)
    step = 2**33 + 5
    ours = step_noise(seeds, step, 22, torch.float64, n_steps=3)
    for k in range(3):
        assert float((ours[k].float() - gaussian_noise(seeds, step + k, 22)).abs().max()) < 1e-5
    attempts = np.array([0, 5, 2**33 + 7])
    port = np.stack([port_uniforms(3**20, int(a), 32, "cpu").numpy() for a in attempts])
    assert np.abs(swap_uniforms(3**20, attempts, 32) - port).max() < 1e-7
    assert np.allclose(ladder(300.0, 450.0, 32), np.geomspace(300.0, 450.0, 32))


#: alanine dipeptide under amber ff14SB (amino12.lib, parm10.dat): each
#: atom's charge and type, and each type's LJ R* (Angstrom) and epsilon
#: (kcal/mol); bonds (kcal/mol/A^2, A) and angles (kcal/mol/rad^2, degrees)
#: by the types they join; mbondi2 radii (A) and HCT screening; OBC2's and
#: GBn2's constants (Onufriev, Bashford & Case 2004; Nguyen, Roe &
#: Simmerling 2013)
ALANINE = [("HH31", 0.1123, "HC"), ("CH3", -0.3662, "CT"), ("HH32", 0.1123, "HC"),
           ("HH33", 0.1123, "HC"), ("C", 0.5972, "C"), ("O", -0.5679, "O"),
           ("N", -0.4157, "N"), ("H", 0.2719, "H"), ("CA", 0.0337, "CT"), ("HA", 0.0823, "H1"),
           ("CB", -0.1825, "CT"), ("HB1", 0.0603, "HC"), ("HB2", 0.0603, "HC"),
           ("HB3", 0.0603, "HC"), ("C", 0.5973, "C"), ("O", -0.5679, "O"),
           ("N", -0.4157, "N"), ("H", 0.2719, "H"), ("CH3", -0.1490, "CT"),
           ("HH31", 0.0976, "H1"), ("HH32", 0.0976, "H1"), ("HH33", 0.0976, "H1")]
LJ = {"HC": (1.4870, 0.0157), "H1": (1.3870, 0.0157), "H": (0.6000, 0.0157),
      "CT": (1.9080, 0.1094), "C": (1.9080, 0.0860), "N": (1.8240, 0.1700),
      "O": (1.6612, 0.2100)}
BONDS = {("CT", "HC"): (340.0, 1.090), ("CT", "H1"): (340.0, 1.090), ("C", "CT"): (317.0, 1.522),
         ("C", "O"): (570.0, 1.229), ("C", "N"): (490.0, 1.335), ("CT", "N"): (337.0, 1.449),
         ("H", "N"): (434.0, 1.010), ("CT", "CT"): (310.0, 1.526)}
ANGLES = {("C", "N", "CT"): (50.0, 121.9), ("CT", "C", "O"): (80.0, 120.4),
          ("N", "C", "O"): (80.0, 122.9), ("C", "CT", "N"): (63.0, 110.1),
          ("HC", "CT", "HC"): (35.0, 109.5), ("CT", "N", "H"): (50.0, 118.04)}
MASS = {"H": 1.008, "C": 12.01, "N": 14.01, "O": 16.00}
OBC2_RADIUS = {"H": 1.2, "C": 1.7, "N": 1.55, "O": 1.5}
OBC2_SCREEN = {"H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85}
GBN2_SCREEN = {"H": 1.425952, "C": 1.058554, "N": 0.733599, "O": 1.061039}
GBN2_ABG = {"H": (0.788440, 0.798699, 0.437334), "C": (0.733756, 0.506378, 0.205844),
            "N": (0.503364, 0.316828, 0.192915), "O": (0.867814, 0.876635, 0.387882)}
KCAL = 4.184


@pytest.mark.parametrize("model", MODELS)
def test_alanine_parameters_are_the_published_ones(model):
    """A witness that is not the port's code: the reference's parameters of
    alanine dipeptide against the published amber and GB values."""
    pdb = REPO / "portbench/inputs/alanine-dipeptide.pdb"
    p, bare = system_params(pdb, 3.0, model), system_params(pdb, None, model)
    assert [n for n, _, _ in ALANINE] == p["atom_names"]
    types = [t for _, _, t in ALANINE]
    elem = [t[0] for t in types]
    np.testing.assert_allclose(p["charges"], [q for _, q, _ in ALANINE], atol=1e-12)
    r_star = np.asarray([LJ[t][0] for t in types])
    np.testing.assert_allclose(p["sigma"], 0.1 * 2.0 * r_star * 2.0 ** (-1.0 / 6.0), rtol=1e-12)
    np.testing.assert_allclose(p["eps"], [LJ[t][1] * KCAL for t in types], rtol=1e-12)
    np.testing.assert_allclose(bare["masses"], [MASS[e] for e in elem], rtol=1e-12)
    h = np.asarray(elem) == "H"
    assert np.allclose(p["masses"][h], 3.0) and p["masses"].sum() == pytest.approx(
        bare["masses"].sum(), abs=1e-9)
    for (i, j), k, r0 in zip(p["bond_idx"], p["bond_k"], p["bond_r0"]):
        kb, rb = BONDS[tuple(sorted((types[i], types[j])))]
        assert (k, r0) == pytest.approx((2.0 * kb * KCAL * 100.0, 0.1 * rb), rel=1e-12)
    seen = 0
    for (i, j, k), ka, t0 in zip(p["angle_idx"], p["angle_k"], p["angle_t0"]):
        key = (types[i], types[j], types[k])
        want = ANGLES.get(key) or ANGLES.get(key[::-1])
        if want:
            seen += 1
            assert (ka, t0) == pytest.approx((2.0 * want[0] * KCAL, np.radians(want[1])),
                                             rel=1e-12)
    assert seen >= 10
    on_n = {i for a, b in p["bond_idx"] for i, o in ((a, b), (b, a))
            if elem[i] == "H" and elem[o] == "N"}
    radii = [1.3 if i in on_n else OBC2_RADIUS[e] for i, e in enumerate(elem)]
    np.testing.assert_allclose(p["gb_radii"], 0.1 * np.asarray(radii), rtol=1e-12)
    if model == "obc2":
        np.testing.assert_allclose(p["gb_screen"], [OBC2_SCREEN[e] for e in elem], rtol=1e-12)
        assert (p["gb_alpha"] == 1.0).all() and (p["gb_beta"] == 0.8).all()
        assert (p["gb_gamma"] == 4.85).all()
        assert (p["gb_offset"], p["gb_neck_scale"]) == (0.009, 0.0)
    else:
        np.testing.assert_allclose(p["gb_screen"], [GBN2_SCREEN[e] for e in elem], rtol=1e-12)
        abg = np.stack([p["gb_alpha"], p["gb_beta"], p["gb_gamma"]], 1)
        np.testing.assert_allclose(abg, [GBN2_ABG[e] for e in elem], rtol=1e-12)
        assert (p["gb_offset"], p["gb_neck_scale"]) == (0.0195141, 0.826836)
