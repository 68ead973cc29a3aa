"""Names of the JAX package's ``md`` modules that the port now has too:
``forces.energy_components``, ``bias_fn=`` on ``potential_energy``,
``compute_forces`` and ``langevin_step``, ``System.select`` and the lazy
``md.build_pair_force_fn``. Each is fed the same seeded numpy inputs in both
packages on the CPU.

Tolerances: energies to 1e-5 relative, forces to 1e-4 of the largest force
(float32 sums taken in another order); positions after 10 steps at friction
0 to 1e-5 nm.
"""

import numpy as np
import pytest
import torch

import pmarlo_tpu_torch.md as tmd
from pmarlo_tpu_torch.md import forces
from pmarlo_tpu_torch.md.integrate import MDState, langevin_step
from pmarlo_tpu_torch.md.system import system_from_numpy

jax = pytest.importorskip("jax")
jnp = jax.numpy

K_RESTRAINT = 500.0   # kJ/mol/nm^2 on the distance of atoms 1 and 18
R_RESTRAINT = 0.35


@pytest.fixture(scope="module")
def alanine():
    """The JAX package's alanine GBn2 system, the port's from its fields,
    and positions near the crystal geometry (seeded numpy)."""
    from pmarlo_tpu.data import alanine_dipeptide_structure
    from pmarlo_tpu.md.forcefield import build_system

    js, jx = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    ts = system_from_numpy(js.to_dict(), device="cpu")
    rng = np.random.default_rng(6)
    x = (np.asarray(jx) + rng.normal(0.0, 0.01, np.shape(jx))).astype(np.float32)
    return js, ts, x


def _jax_bias(x):
    d = jnp.linalg.norm(x[1] - x[18])
    return K_RESTRAINT * (d - R_RESTRAINT) ** 2


def _torch_bias(x):
    d = torch.linalg.norm(x[..., 1, :] - x[..., 18, :], dim=-1)
    return K_RESTRAINT * (d - R_RESTRAINT) ** 2


def test_energy_components_match_jax(alanine):
    from pmarlo_tpu.md.forces import energy_components as jax_components

    js, ts, x = alanine
    jc = {k: float(v) for k, v in jax_components(js, jnp.asarray(x)).items()}
    tc = {k: float(v) for k, v in forces.energy_components(ts, torch.from_numpy(x)).items()}
    assert set(tc) == set(jc) == {"bond", "angle", "torsion", "nonbonded", "gb"}
    for k, je in jc.items():
        assert abs(tc[k] - je) <= 1e-5 * max(abs(je), 1.0), k
    total = float(forces.potential_energy(ts, torch.from_numpy(x)))
    assert abs(total - sum(jc.values())) <= 1e-5 * abs(sum(jc.values()))


@pytest.mark.parametrize("biased", [False, True], ids=["no_bias", "bias_fn"])
def test_potential_energy_and_compute_forces_take_bias_fn_as_jax(alanine, biased):
    from pmarlo_tpu.md.forces import compute_forces as jax_forces
    from pmarlo_tpu.md.forces import potential_energy as jax_energy

    js, ts, x = alanine
    jb, tb = (_jax_bias, _torch_bias) if biased else (None, None)
    je = float(jax_energy(js, jnp.asarray(x), jb))
    jf = np.asarray(jax_forces(js, jnp.asarray(x), jb))
    te = float(forces.potential_energy(ts, torch.from_numpy(x), bias_fn=tb))
    tf = forces.compute_forces(ts, torch.from_numpy(x), bias_fn=tb).numpy()
    assert abs(te - je) <= 1e-5 * abs(je)
    assert np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()
    if biased:
        # the bias moves both the energy and the two restrained atoms
        e0 = float(forces.potential_energy(ts, torch.from_numpy(x)))
        assert te - e0 == pytest.approx(float(_torch_bias(torch.from_numpy(x))), rel=1e-4)
        assert np.abs(tf - forces.compute_forces(ts, torch.from_numpy(x)).numpy()).max() > 1.0


def test_langevin_step_with_bias_fn_matches_jax(alanine):
    """10 steps at friction 0 (no noise enters) under the restraint, from
    the same positions and velocities."""
    from pmarlo_tpu.md.integrate import MDState as JState
    from pmarlo_tpu.md.integrate import langevin_step as jax_step

    js, ts, x = alanine
    rng = np.random.default_rng(7)
    v = rng.normal(0.0, 0.3, x.shape).astype(np.float32)
    dt, n_steps = 0.002, 10

    jstate = JState(positions=jnp.asarray(x), velocities=jnp.asarray(v),
                    key=jax.random.PRNGKey(0), step=jnp.int32(0))
    step = jax.jit(lambda s: jax_step(js, s, dt=dt, friction=0.0, temperature_K=300.0,
                                      bias_fn=_jax_bias))
    tstate = MDState(positions=torch.from_numpy(x)[None], velocities=torch.from_numpy(v)[None],
                     seeds=torch.zeros(1, dtype=torch.int32))
    temps = torch.full((1,), 300.0)
    for _ in range(n_steps):
        jstate, je = step(jstate)
        tstate, te = langevin_step(ts, tstate, dt=dt, friction=0.0, temperature_K=temps,
                                   bias_fn=_torch_bias)
        assert abs(float(te[0]) - float(je)) <= 1e-5 * abs(float(je))
    np.testing.assert_allclose(tstate.positions[0].numpy(), np.asarray(jstate.positions),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="not both"):
        langevin_step(ts, tstate, dt=dt, friction=0.0, temperature_K=temps,
                      bias_fn=_torch_bias, force_fn=lambda y: (None, None))


@pytest.mark.parametrize("biased", [False, True], ids=["no_bias", "bias_fn"])
def test_make_force_fn_autograd_matches_jax_and_the_analytic_path(alanine, biased):
    """``make_force_fn(analytic=False)``: the energy ``potential_energy``
    (bias included) and its autograd forces, against JAX's autodiff path
    and the port's analytic path, batched over a leading dimension."""
    from pmarlo_tpu.md.integrate import make_force_fn as jax_make_force_fn

    from pmarlo_tpu_torch.md.integrate import make_force_fn

    js, ts, x = alanine
    jb, tb = (_jax_bias, _torch_bias) if biased else (None, None)
    je, jf = jax_make_force_fn(js, jb, analytic=False)(jnp.asarray(x))
    te, tf = make_force_fn(ts, tb, analytic=False)(torch.from_numpy(x))
    ae, af = make_force_fn(ts, tb)(torch.from_numpy(x))
    for e, f in ((te, tf), (ae, af)):
        assert abs(float(e) - float(je)) <= 1e-5 * abs(float(je))
        assert np.abs(f.numpy() - np.asarray(jf)).max() <= 1e-4 * np.abs(np.asarray(jf)).max()
    xs = torch.from_numpy(np.stack([x, x]))
    be, bf = make_force_fn(ts, tb, analytic=False)(xs)
    assert be.shape == (2,) and torch.allclose(bf[0], tf, rtol=0, atol=1e-3)


def test_make_force_fn_autograd_spreads_virtual_site_forces_as_jax():
    """On the 27-water TIP4P-Ew box of JAX's tests, the autograd path is
    wrapped for the sites as JAX wraps its own: forces on the massless M
    rows are spread onto O, H1 and H2."""
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system
    from pmarlo_tpu.md.integrate import make_force_fn as jax_make_force_fn
    from tests.unit.test_tip4pew import _t4_box

    from pmarlo_tpu_torch.md.integrate import make_force_fn

    s, box = _t4_box(3)
    js, jx = jax_build_system(s, box=box, cutoff=0.5, hydrogen_mass=None)
    ts = system_from_numpy(js.to_dict(), device="cpu")
    x = (np.asarray(jx) + np.random.default_rng(8).normal(0.0, 0.005, np.shape(jx))).astype(
        np.float32)
    je, jf = jax_make_force_fn(js, analytic=False)(jnp.asarray(x))
    te, tf = make_force_fn(ts, analytic=False)(torch.from_numpy(x))
    assert abs(float(te) - float(je)) <= max(1e-5 * abs(float(je)), 1e-3)
    jf = np.asarray(jf)
    assert np.abs(tf.numpy() - jf).max() <= 1e-4 * np.abs(jf).max()
    sites = np.asarray(js.vsite_idx)[:, 0]
    assert np.abs(tf.numpy()[sites]).max() == 0.0


@pytest.mark.parametrize("name", ["CA", "H", "N", "XX"])
def test_system_select_matches_jax(alanine, name):
    js, ts, _ = alanine
    got, want = ts.select(name), js.select(name)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_md_exports_build_pair_force_fn_lazily_as_jax(alanine):
    """``pmarlo_tpu_torch.md.build_pair_force_fn`` is the pair path of
    ``md.pair_force`` (imported on first call), and agrees with the JAX
    package's ``md.build_pair_force_fn`` (its Pallas kernel in interpret
    mode)."""
    import pmarlo_tpu.md as jmd
    from pmarlo_tpu_torch.md import pair_force

    js, ts, x = alanine
    assert "build_pair_force_fn" in tmd.__all__
    te, tf = tmd.build_pair_force_fn(ts)(torch.from_numpy(x))
    pe, pf = pair_force.build_pair_force_fn(ts)(torch.from_numpy(x))
    assert torch.equal(te, pe) and torch.equal(tf, pf)
    je, jf = jmd.build_pair_force_fn(js, tile=128, interpret=True)(jnp.asarray(x))
    assert abs(float(te) - float(je)) <= 1e-5 * abs(float(je))
    assert np.abs(tf.numpy() - np.asarray(jf)).max() <= 1e-4 * np.abs(np.asarray(jf)).max()


#: the JAX package's modules that the solvated production slice ports: each
#: name of a source's ``__all__`` is in the port's module of the same path
PRODUCTION_MODULES = ["md.eft", "md.pme", "md.barostat", "md.simulation", "io", "io.cif",
                      "io.trajectory", "io.xtc", "io.dcd", "io.trr", "io.netcdf", "io.shards",
                      "io.export", "remd.demux", "remd.checkpoint"]
#: the modules the virtual-site water slice ports
PRODUCTION_MODULES += ["md.vsites", "md.amber_params", "protein.solvate", "ml.plumed"]
#: names of JAX modules without ``__all__`` (or of ones ported only in
#: part) that the virtual-site water slice ports
SLICE_NAMES = {
    "features.rdf": ["radial_distribution", "coordination_number"],
    "features.msd": ["unwrap_trajectory", "mean_squared_displacement",
                     "diffusion_coefficient"],
    "features": ["radial_distribution", "coordination_number", "unwrap_trajectory",
                 "mean_squared_displacement", "diffusion_coefficient"],
    "features.builtins": ["align_to_reference"],
    "protein": ["solvate_structure", "structure_formal_charge"],
    "md": ["load_amber_files"],
}
#: modules the port names otherwise (their TPU kernels became CUDA files)
RENAMED = {"pallas_pair": "pair_force", "pallas_periodic": "periodic_force",
           "pallas_cells": "cell_force"}


@pytest.mark.parametrize("module", PRODUCTION_MODULES)
def test_production_modules_export_the_jax_names(module):
    import importlib

    jm = importlib.import_module(f"pmarlo_tpu.{module}")
    tm = importlib.import_module(f"pmarlo_tpu_torch.{module}")
    assert jm.__all__
    assert [n for n in jm.__all__ if not hasattr(tm, n)] == []


@pytest.mark.parametrize("module", sorted(SLICE_NAMES))
def test_slice_names_are_in_the_port(module):
    import importlib

    jm = importlib.import_module(f"pmarlo_tpu.{module}")
    tm = importlib.import_module(f"pmarlo_tpu_torch.{module}")
    for name in SLICE_NAMES[module]:
        assert hasattr(jm, name) and hasattr(tm, name), name


def test_deeptica_model_has_the_export_methods_of_jax():
    from pmarlo_tpu.ml.deeptica import DeepTICAModel as JaxModel

    from pmarlo_tpu_torch.ml.deeptica import DeepTICAModel

    for name in ("to_torchscript", "plumed_snippet"):
        assert callable(getattr(JaxModel, name)) and callable(getattr(DeepTICAModel, name))


def test_run_segment_takes_every_argument_of_jax():
    """Every keyword of JAX's ``run_segment``, with its default; the port
    adds ``device`` only."""
    import inspect

    from pmarlo_tpu.md.simulation import run_segment as jax_run_segment
    from pmarlo_tpu_torch.md.simulation import run_segment

    jp = inspect.signature(jax_run_segment).parameters
    tp = inspect.signature(run_segment).parameters
    assert set(tp) - set(jp) == {"device"} and set(jp) <= set(tp)
    for name, p in jp.items():
        assert tp[name].default == p.default, name
        assert tp[name].kind == p.kind, name


def test_package_registry_resolves_the_jax_names():
    """``pmarlo_tpu_torch.<name>`` resolves lazily, as JAX's registry does,
    for each name the port has: the same name, the module of the same path
    (or its port's name), the same attribute."""
    import pmarlo_tpu

    import pmarlo_tpu_torch
    from pmarlo_tpu_torch.md import simulation

    for name, (module, attr) in pmarlo_tpu_torch._EXPORTS.items():
        jmodule, jattr = pmarlo_tpu._EXPORTS[name]
        want = jmodule.replace("pmarlo_tpu", "pmarlo_tpu_torch", 1)
        for old, new in RENAMED.items():
            want = want.replace(old, new)
        assert (module, attr) == (want, jattr), name
        assert getattr(pmarlo_tpu_torch, name) is not None
    assert pmarlo_tpu_torch.run_segment is simulation.run_segment
    assert "run_segment" in dir(pmarlo_tpu_torch)
    with pytest.raises(AttributeError):
        pmarlo_tpu_torch.no_such_name
