"""The port's solvation box (``pmarlo_tpu_torch/protein/solvate.py``, a
host copy of the JAX module) against the JAX package's, the mirror of
``test_solvate_water_model_tip4pew`` / ``_tip5p``: atom for atom at the
same seed for TIP3P, TIP4P-Ew and TIP5P, every box shape, and the systems
it gives build with the rigid-water stride of their model."""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.md.constraints import build_h_constraints
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.vsites import VirtualSites, n_vsites
from pmarlo_tpu_torch.protein import solvate_structure, structure_formal_charge

MODELS = {"tip3p": (3, ()), "tip4pew": (4, ("M",)), "tip5p": (5, ("L1", "L2"))}


def _atoms(s):
    return [(r.name, r.resid, r.chain, a.name, a.element, a.xyz)
            for r in s.residues for a in r.atoms]


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("shape", ["rectangular", "cubic", "dodecahedron"])
def test_solvate_matches_jax_atom_for_atom(model, shape):
    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
    from pmarlo_tpu.protein.solvate import solvate_structure as jax_solvate

    kw = dict(padding=0.8, water_model=model, box_shape=shape, seed=7)
    s, box = solvate_structure(alanine_dipeptide_structure(), **kw)
    js, jbox = jax_solvate(jax_alanine(), **kw)
    assert box == jbox and s.box == js.box and s.tilt == js.tilt
    assert _atoms(s) == _atoms(js)
    waters = [r for r in s.residues if r.name == "HOH"]
    size, sites = MODELS[model]
    assert waters and all(len(r.atoms) == size for r in waters)
    assert all(tuple(a.name for a in r.atoms[3:]) == sites for r in waters)


def test_formal_charge_matches_jax():
    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
    from pmarlo_tpu.protein.solvate import structure_formal_charge as jax_charge

    assert structure_formal_charge(alanine_dipeptide_structure()) == jax_charge(jax_alanine())


@pytest.mark.parametrize("model", ["tip4pew", "tip5p"])
def test_solvated_system_builds_with_the_site_stride(model):
    s, box = solvate_structure(alanine_dipeptide_structure(), padding=1.0, water_model=model)
    system, x = build_system(s, box=box, cutoff=0.9, hydrogen_mass=None, device="cpu")
    n_w = sum(r.name == "HOH" for r in s.residues)
    assert n_vsites(system) == n_w * (1 if model == "tip4pew" else 2)
    spec = build_h_constraints(system)
    assert spec is not None and spec.water is not None
    assert spec.water.stride == MODELS[model][0] and spec.water.n_waters == n_w
    # the sites as written sit on their parents
    vs = VirtualSites.from_system(system)
    assert float((vs.expand(x) - x).abs().max()) <= 1e-6
    assert isinstance(x, torch.Tensor) and np.isfinite(x.numpy()).all()
