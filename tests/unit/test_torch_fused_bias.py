"""The in-kernel CV bias of the fused chunk (``md/cv_bias.py``,
``md/fused_md.py``, ``md/enhanced_sampling.py``): the plain version against
``pallas_md._bias_planes`` / ``_cv_forward`` called as plain jnp functions
(as ``tests/unit/test_pallas_md.py`` does), against autograd of ``bias/``
over ``ml/``, the fused-deposit loop against JAX ``MetadynamicsBias.deposit``,
and the CUDA kernels against the plain version on the card.

JAX is imported inside the tests that compare against it, so that the
``gpu`` tests also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_fused_bias.py``.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.bias import HarmonicExpansionBias, MetadynamicsBias, make_cv_bias_fn
from pmarlo_tpu_torch.bias.harmonic import make_feature_cv_fn, make_phi_psi_feature_fn
from pmarlo_tpu_torch.bias.metadynamics import metad_state_from_numpy
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.features import TopologyInfo, phi_psi_indices
from pmarlo_tpu_torch.md import enhanced_sampling, forcefield, fused_md, setup
from pmarlo_tpu_torch.md.cv_bias import MAX_CV, MAX_LAYERS, CVBias
from pmarlo_tpu_torch.md.enhanced_sampling import run_fused_metadynamics
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
from pmarlo_tpu_torch.md.integrate import (
    MDState,
    bias_energy_and_forces,
    langevin_step,
    make_force_fn,
)
from pmarlo_tpu_torch.md.topology import build_topology
from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig, deeptica_from_numpy

DT = 0.002
SIGMA = (0.4, 0.3)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _molecule(name, device="cpu"):
    structure = alanine_dipeptide_structure() if name == "alanine" else chignolin_structure()
    info = TopologyInfo.from_topology(build_topology(structure))
    system, pos = build_system(structure, gb_model="gbn2", device=device)
    phi, psi, _ = phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    return system, pos, info, np.concatenate([phi, psi], 0)


def _model(n_dihedrals, hidden=(8,), n_out=2, whiten=True, seed=0, device="cpu"):
    """A tanh DeepTICA model made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    k = 2 * n_dihedrals
    sizes = [k, *hidden, n_out]
    params = [{"w": rng.normal(0.0, np.sqrt(2.0 / (a + b)), (a, b)).astype(np.float32),
               "b": rng.normal(0.0, 0.1, b).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    whitening = None
    if whiten:
        whitening = {"mean": rng.normal(0.0, 0.1, n_out).astype(np.float32),
                     "transform": rng.normal(0.0, 1.0, (n_out, n_out)).astype(np.float32)}
    return deeptica_from_numpy(
        DeepTICAConfig(hidden=tuple(hidden), n_out=n_out), params,
        rng.normal(0.0, 0.3, k).astype(np.float32),
        rng.uniform(0.5, 1.0, k).astype(np.float32), whitening, device=device)


def _positions(pos, R, seed=1, sigma=0.01):
    rng = np.random.default_rng(seed)
    x = pos.cpu().numpy()[None] + rng.normal(0.0, sigma, (R,) + tuple(pos.shape))
    return torch.as_tensor(x, dtype=torch.float32, device=pos.device)


def _ledger(n_cv, n_valid, capacity, seed=2, device="cpu"):
    rng = np.random.default_rng(seed)
    centers = np.zeros((capacity, n_cv), np.float32)
    heights = np.zeros(capacity, np.float32)
    centers[:n_valid] = rng.normal(0.0, 0.6, (n_valid, n_cv))
    heights[:n_valid] = rng.uniform(0.2, 2.0, n_valid)
    # stale values past the valid prefix must not count
    centers[n_valid:] = 0.1
    heights[n_valid:] = 5.0
    return metad_state_from_numpy(centers, heights, n_valid, device=device)


def _jax_consts(model, quads, n_atoms, strength, hills=None):
    """The constants ``pallas_md._bias_planes`` reads, from the port's model."""
    import jax.numpy as jnp

    from pmarlo_tpu.md import pallas_md as PM
    from pmarlo_tpu.ml.deeptica import DeepTICAConfig as JConfig
    from pmarlo_tpu.ml.deeptica import DeepTICAModel as JModel

    jmodel = JModel(
        config=JConfig(hidden=model.config.hidden, n_out=model.config.n_out),
        params=[{k: jnp.asarray(v.cpu().numpy()) for k, v in layer.items()}
                for layer in model.params],
        scaler_mean=model.scaler_mean, scaler_scale=model.scaler_scale,
        whitening=model.whitening)
    b_consts, b_statics, quads2 = PM._bias_consts(jmodel, quads, strength)
    consts = {k: jnp.asarray(v) for k, v in b_consts.items()}
    consts.update(b_statics)
    consts["bias_S"] = jnp.asarray(PM._pack_selectors_for_quads(quads2, n_atoms))
    if hills is not None:
        H = hills.heights.shape[0]
        consts["bias_kind"] = "metadynamics"
        consts["mtd_inv_sigma_list"] = [float(v) for v in 1.0 / np.asarray(SIGMA, np.float64)]
        consts["mtd_centers_t"] = jnp.asarray(hills.centers.numpy().T)
        consts["mtd_heights"] = jnp.asarray(hills.heights.numpy()[None, :])
        consts["mtd_mask"] = (jnp.arange(H) < int(hills.n_hills)).astype(jnp.float32)[None, :]
    return PM, consts


# --- the plain version against the TPU kernel's plane functions -----------------------------

@pytest.mark.parametrize("name,whiten", [("alanine", True), ("alanine", False),
                                         ("chignolin", True)])
@pytest.mark.parametrize("kind", ["harmonic", "metadynamics"])
def test_bias_twin_matches_pallas_bias_planes(name, whiten, kind):
    """Energy to 1e-3 absolute and forces to 1e-4 of the largest force, the
    tolerances of ``test_pallas_md.py``; the CVs against ``_cv_forward`` to
    1e-5."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    system, pos, info, quads = _molecule(name)
    model = _model(len(quads), whiten=whiten)
    hills = _ledger(2, 9, 16) if kind == "metadynamics" else None
    bias = CVBias(model, quads, n_atoms=system.n_atoms, strength=1.5, kind=kind,
                  mtd_sigma=SIGMA if hills is not None else None)
    x = _positions(pos, 3)
    e, f = bias.energy_and_forces(x, hills)
    PM, consts = _jax_consts(model, quads, system.n_atoms, 1.5, hills)
    xj = jnp.asarray(x.numpy())
    f0, f1, f2, je = PM._bias_planes(xj[..., 0], xj[..., 1], xj[..., 2], consts)
    jf = np.stack([np.asarray(f0), np.asarray(f1), np.asarray(f2)], -1)
    scale = max(np.abs(jf).max(), 1e-6)
    assert np.abs(e.numpy() - np.asarray(je)[:, 0]).max() < 1e-3
    assert np.abs(f.numpy() - jf).max() / scale < 1e-4
    jcv = np.asarray(PM._cv_forward(xj[..., 0], xj[..., 1], xj[..., 2], consts))
    np.testing.assert_allclose(bias.cv(x).numpy(), jcv, atol=1e-5)


@pytest.mark.parametrize("kind", ["harmonic", "metadynamics"])
def test_bias_twin_matches_autograd_of_bias_over_ml(kind):
    """The hand-written gradient against autograd of ``bias/`` composed
    with ``ml/`` (1e-4 of the largest force; 1e-4 relative energy: the
    composition goes through atan2 and cos, the twin takes cos and sin from
    the cross products, and the Gaussians amplify that rounding)."""
    system, pos, info, quads = _molecule("chignolin")
    model = _model(len(quads), hidden=(8, 8))
    hills = _ledger(2, 12, 32) if kind == "metadynamics" else None
    bias = CVBias(model, quads, n_atoms=system.n_atoms, strength=2.0, kind=kind,
                  mtd_sigma=SIGMA if hills is not None else None)
    cv_fn = make_feature_cv_fn(
        make_phi_psi_feature_fn(info.atom_names, info.residue_ids, chain_ids=info.chain_ids),
        model.as_function())
    if hills is None:
        bias_fn = make_cv_bias_fn(cv_fn, HarmonicExpansionBias(strength=2.0))
    else:
        bias_fn = MetadynamicsBias(sigma=SIGMA, max_hills=32).bias_fn(hills, cv_fn)
    x = _positions(pos, 4)
    e, f = bias.energy_and_forces(x, hills)
    ea, fa = bias_energy_and_forces(bias_fn, x)
    assert float((e - ea).abs().max() / ea.abs().max()) <= 1e-4
    assert float((f - fa).abs().max() / fa.abs().max()) <= 1e-4
    assert float(fa.abs().max()) > 0.0
    torch.testing.assert_close(bias.cv(x), cv_fn(x), atol=1e-5, rtol=0)
    # the bias moves no centre of mass: its forces sum to zero
    assert float(f.sum(1).abs().max()) <= 1e-3


def test_stale_ledger_slots_do_not_count():
    system, pos, info, quads = _molecule("alanine")
    model = _model(len(quads))
    bias = CVBias(model, quads, n_atoms=system.n_atoms, kind="metadynamics", mtd_sigma=SIGMA)
    x = _positions(pos, 2)
    full = _ledger(2, 5, 16)
    cut = metad_state_from_numpy(full.centers[:5].numpy(), full.heights[:5].numpy(), 5)
    e1, f1 = bias.energy_and_forces(x, full)
    e2, f2 = bias.energy_and_forces(x, cut)
    torch.testing.assert_close(e1, e2)
    torch.testing.assert_close(f1, f2)
    empty = metad_state_from_numpy(full.centers.numpy(), full.heights.numpy(), 0)
    e0, f0 = bias.energy_and_forces(x, empty)
    assert float(e0.abs().max()) == 0.0 and float(f0.abs().max()) == 0.0


# --- the tables the kernel reads -----------------------------------------------------------

def test_dihedral_csr_lists_every_role_once():
    system, pos, info, quads = _molecule("chignolin")
    bias = CVBias(_model(len(quads)), quads, n_atoms=system.n_atoms)
    ptr, ent = bias.dihedral_csr()
    assert ptr[0] == 0 and ptr[-1] == len(ent) == 4 * len(quads)
    seen = set()
    for atom in range(system.n_atoms):
        for role, d in ent[ptr[atom]:ptr[atom + 1]]:
            assert int(quads[d, role]) == atom
            seen.add((int(role), int(d)))
    assert len(seen) == 4 * len(quads)


def test_blob_layout_and_work_space():
    """mu, 1/sigma, then (w, b) a layer with w stored (in, out), then the
    whitening mean and matrix; identity whitening when the model has none."""
    system, pos, info, quads = _molecule("alanine")
    model = _model(len(quads), hidden=(8, 4), whiten=False)
    bias = CVBias(model, quads, n_atoms=system.n_atoms)
    blob = bias.blob().numpy()
    k = 2 * len(quads)
    assert bias.widths == [k, 8, 4, 2]
    assert blob.size == 2 * k + (k * 8 + 8) + (8 * 4 + 4) + (4 * 2 + 2) + 2 + 4
    np.testing.assert_allclose(blob[:k], model.scaler_mean)
    np.testing.assert_allclose(blob[k:2 * k], 1.0 / model.scaler_scale, rtol=1e-6)
    w0 = model.params[0]["w"].numpy()
    np.testing.assert_array_equal(blob[2 * k:2 * k + k * 8].reshape(k, 8), w0)
    np.testing.assert_array_equal(blob[-4:].reshape(2, 2), np.eye(2))
    np.testing.assert_array_equal(blob[-6:-4], 0.0)
    assert bias.work_floats() == blob.size + sum(bias.widths) + MAX_CV + 2 * 8 + 3 * 2 + 32
    # default width on chignolin fits one CTA's static share of shared memory
    csys, _, _, cquads = _molecule("chignolin")
    wide = CVBias(_model(len(cquads), hidden=(64, 64)), cquads, n_atoms=csys.n_atoms)
    assert 4 * (wide.work_floats() + 5 * csys.n_atoms + 256) < 48 * 1024


def test_bias_refuses_what_the_kernel_cannot_take():
    import dataclasses

    system, pos, info, quads = _molecule("alanine")
    model = _model(len(quads))
    for field, value, match in (("activation", "gelu", "tanh"), ("layernorm", True, "layernorm")):
        bad = dataclasses.replace(model, config=dataclasses.replace(model.config, **{field: value}))
        with pytest.raises(ValueError, match=match):
            CVBias(bad, quads, n_atoms=system.n_atoms)
    with pytest.raises(ValueError, match="harmonic|metadynamics"):
        CVBias(model, quads, n_atoms=system.n_atoms, kind="opes")
    with pytest.raises(ValueError, match="mtd_sigma"):
        CVBias(model, quads, n_atoms=system.n_atoms, kind="metadynamics")
    with pytest.raises(ValueError, match="features"):
        CVBias(model, quads[:1], n_atoms=system.n_atoms)
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        CVBias(model, quads, n_atoms=5)
    deep = _model(len(quads), hidden=(4,) * MAX_LAYERS)
    with pytest.raises(ValueError, match="at most"):
        CVBias(deep, quads, n_atoms=system.n_atoms)
    with pytest.raises(ValueError, match="bias_quads"):
        build_fused_chunk(system, dt=DT, friction=1.0, n_replicas=2, bias_model=model)


# --- the biased chunk's plain version --------------------------------------------------------

def _md_inputs(system, pos, R, seed=3):
    rng = np.random.default_rng(seed)
    x = _positions(pos, R, seed=seed, sigma=0.005)
    temps = torch.as_tensor(np.linspace(300.0, 400.0, R), dtype=torch.float32,
                            device=pos.device)
    m = system.masses.cpu().numpy()
    v = np.sqrt(0.00831446261815324 * temps.cpu().numpy()[:, None, None]
                / m[None, :, None]) * rng.standard_normal((R, system.n_atoms, 3))
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, R), dtype=torch.int32,
                            device=pos.device)
    return x, torch.as_tensor(v, dtype=torch.float32, device=pos.device), seeds, temps


def test_biased_chunk_reference_is_langevin_under_the_composed_force():
    """The biased twin equals ``langevin_step`` under
    ``make_force_fn(system, bias_fn)`` (autograd bias) to float rounding,
    and its energies include the bias."""
    system, pos, info, quads = _molecule("alanine")
    model = _model(len(quads))
    R = 2
    x, v, seeds, temps = _md_inputs(system, pos, R)
    chunk = build_fused_chunk(system, dt=DT, friction=1.0, n_replicas=R,
                              bias_model=model, bias_quads=quads, bias_strength=2.0)
    xo, vo, eo = chunk(x, v, seeds, temps, 10, 5)
    bias_fn = make_cv_bias_fn(
        make_feature_cv_fn(make_phi_psi_feature_fn(info.atom_names, info.residue_ids),
                           model.as_function()),
        HarmonicExpansionBias(strength=2.0))
    force_fn = make_force_fn(system, bias_fn)
    state = MDState(positions=x, velocities=v, seeds=seeds, step=5)
    for _ in range(10):
        state, _ = langevin_step(system, state, dt=DT, friction=1.0,
                                 temperature_K=temps, force_fn=force_fn)
    assert float((xo - state.positions).abs().max()) <= 1e-5
    # 1e-4 absolute: a total energy is a small difference of large terms
    np.testing.assert_allclose(eo.numpy(), force_fn(state.positions)[0].numpy(),
                               rtol=1e-5, atol=1e-4)
    unbiased = build_fused_chunk(system, dt=DT, friction=1.0, n_replicas=R)
    e_b, _ = chunk.energy_and_forces(x)
    e_u, _ = unbiased.energy_and_forces(x)
    np.testing.assert_allclose((e_b - e_u).numpy(), bias_fn(x).detach().numpy(),
                               rtol=1e-3, atol=1e-4)


def test_chunk_validates_the_ledger():
    system, pos, info, quads = _molecule("alanine")
    model = _model(len(quads))
    R = 2
    x, v, seeds, temps = _md_inputs(system, pos, R)
    kw = dict(dt=DT, friction=1.0, n_replicas=R, bias_model=model, bias_quads=quads)
    mtd_chunk = build_fused_chunk(system, bias_kind="metadynamics", mtd_sigma=SIGMA, **kw)
    with pytest.raises(ValueError, match="hills ledger"):
        mtd_chunk(x, v, seeds, temps, 1, 0)
    with pytest.raises(ValueError, match="hills ledger"):
        build_fused_chunk(system, **kw)(x, v, seeds, temps, 1, 0, hills=_ledger(2, 1, 4))
    with pytest.raises(ValueError, match="hills.centers"):
        mtd_chunk(x, v, seeds, temps, 1, 0, hills=_ledger(3, 1, 4))
    with pytest.raises(ValueError, match="needs a metadynamics bias"):
        build_fused_chunk(system, mtd_deposit_interval=5, **kw)
    fused = build_fused_chunk(system, bias_kind="metadynamics", mtd_sigma=SIGMA,
                              mtd_deposit_interval=4, **kw)
    with pytest.raises(ValueError, match="multiple of mtd_deposit_interval"):
        fused(x, v, seeds, temps, 6, 0, hills=_ledger(2, 0, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.remd(x, v, seeds, torch.arange(R, dtype=torch.int32), temps, n_attempts=1,
                   frames_per_attempt=1, report_interval=1, step_offset=0, swap_seed=0,
                   attempt_offset=0)


@pytest.mark.parametrize("bias_factor", [None, 8.0], ids=["standard", "well_tempered"])
def test_fused_deposit_twin_matches_a_loop_of_jax_deposits(bias_factor):
    """The twin's ledger after two deposit windows against JAX
    ``MetadynamicsBias.deposit`` called in replica order on the CVs the
    replicas had at each window's end (centres 1e-5, heights 1e-5
    relative), and a full ledger takes no more hills."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmarlo_tpu.bias import MetadynamicsBias as JMetaD

    system, pos, info, quads = _molecule("alanine")
    model = _model(len(quads))
    R, interval, capacity = 3, 4, 5
    x, v, seeds, temps = _md_inputs(system, pos, R)
    chunk = build_fused_chunk(
        system, dt=DT, friction=1.0, n_replicas=R, bias_model=model, bias_quads=quads,
        bias_kind="metadynamics", mtd_sigma=SIGMA, mtd_deposit_interval=interval,
        mtd_height=1.3, mtd_bias_factor=bias_factor)
    mtd = MetadynamicsBias(sigma=SIGMA, height=1.3, max_hills=capacity,
                           bias_factor=bias_factor)
    h0 = mtd.init_state(2)
    xo, vo, eo, hills = chunk(x, v, seeds, temps, 2 * interval, 0, hills=h0)
    assert int(hills.n_hills) == capacity          # 6 deposits into 5 slots

    # replay: the windows' CVs, then JAX deposits in replica order
    jm = JMetaD(sigma=SIGMA, height=1.3, max_hills=capacity, bias_factor=bias_factor)
    js = jm.init_state(2)
    ledger = h0
    plain = build_fused_chunk(
        system, dt=DT, friction=1.0, n_replicas=R, bias_model=model, bias_quads=quads,
        bias_kind="metadynamics", mtd_sigma=SIGMA)
    xs, vs = x, v
    for w in range(2):
        xs, vs, _ = plain(xs, vs, seeds, temps, interval, w * interval, hills=ledger)
        cvs = plain.bias.cv(xs).numpy()
        for r in range(R):
            js = jm.deposit(js, jnp.asarray(cvs[r]))
        ledger = metad_state_from_numpy(np.asarray(js.centers), np.asarray(js.heights),
                                        int(js.n_hills))
    torch.testing.assert_close(xo, xs, atol=1e-6, rtol=0)
    np.testing.assert_allclose(hills.centers.numpy(), np.asarray(js.centers), atol=1e-5)
    np.testing.assert_allclose(hills.heights.numpy(), np.asarray(js.heights), rtol=1e-5)
    np.testing.assert_allclose(
        eo.numpy(), plain.energy_and_forces(xs, ledger)[0].numpy(), rtol=1e-5)
    if bias_factor is not None:
        assert bool((hills.heights[1:] < 1.3).all()) and float(hills.heights[0]) == \
            pytest.approx(1.3)


def test_run_fused_metadynamics_on_the_cpu_runs_the_plain_version():
    system, pos, info, quads = _molecule("alanine")
    model = _model(len(quads))
    mtd = MetadynamicsBias(sigma=SIGMA, height=2.0, max_hills=64, bias_factor=8.0)
    before = dict(fused_md.variant_launches)
    out = run_fused_metadynamics(
        system, pos, cv_model=model, cv_quads=quads, mtd=mtd, n_steps=12,
        deposit_interval=4, n_replicas=2, device="cpu")
    assert int(out["hills"].n_hills) == 6 == out["n_windows"] * 2
    h = out["hills"].heights[:6]
    assert bool(((h > 0.0) & (h <= 2.0)).all())
    assert out["positions"].shape == (2, system.n_atoms, 3)
    assert bool(torch.isfinite(out["potential_energy"]).all())
    assert fused_md.variant_launches == before
    # the chunk is reusable and the ledger carries on
    again = run_fused_metadynamics(
        system, pos, cv_model=model, cv_quads=quads, mtd=mtd, n_steps=4,
        deposit_interval=4, n_replicas=2, device="cpu", hills=out["hills"],
        chunk=out["chunk"])
    assert int(again["hills"].n_hills) == 8 and again["chunk"] is out["chunk"]
    with pytest.raises(ValueError, match="multiple of deposit_interval"):
        run_fused_metadynamics(system, pos, cv_model=model, cv_quads=quads, mtd=mtd,
                               n_steps=10, deposit_interval=4, device="cpu")


# --- entry points default to the card -----------------------------------------------------------

@pytest.mark.parametrize("entry", ["build_system", "build_implicit_setup",
                                   "run_fused_metadynamics", "run_replica_exchange"])
def test_entry_points_resolve_device_none_through_default_device(entry, monkeypatch):
    """``device=None`` asks ``_device.default_device()`` (the card when
    there is one); an explicit device does not."""
    from pmarlo_tpu_torch import _device
    from pmarlo_tpu_torch.remd import remd as remd_mod

    calls = []

    def fake_default():
        calls.append(entry)
        return torch.device("cpu")

    structure = alanine_dipeptide_structure()
    if entry == "build_system":
        monkeypatch.setattr(forcefield, "default_device", fake_default)
        run = lambda **kw: build_system(structure, gb_model="gbn2", **kw)  # noqa: E731
    elif entry == "build_implicit_setup":
        monkeypatch.setattr(setup, "default_device", fake_default)
        run = lambda **kw: setup.build_implicit_setup(structure, **kw)  # noqa: E731
    elif entry == "run_fused_metadynamics":
        monkeypatch.setattr(enhanced_sampling, "default_device", fake_default)
        system, pos, info, quads = _molecule("alanine")
        mtd = MetadynamicsBias(sigma=SIGMA, max_hills=8)
        run = lambda **kw: run_fused_metadynamics(  # noqa: E731
            system, pos, cv_model=_model(len(quads)), cv_quads=quads, mtd=mtd,
            n_steps=2, deposit_interval=2, **kw)
    else:
        monkeypatch.setattr(remd_mod, "default_device", fake_default)
        cfg = remd_mod.RemdConfig(n_replicas=2, exchange_frequency=5, report_interval=5)
        run = lambda **kw: remd_mod.run_replica_exchange(  # noqa: E731
            structure, n_steps=5, config=cfg, **kw)
    run()
    assert calls
    calls.clear()
    run(device="cpu")
    assert not calls
    assert _device.default_device().type == ("cuda" if torch.cuda.is_available() else "cpu")


# --- the kernels on the card --------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("name,hidden", [("alanine", (64, 64)), ("chignolin", (64, 64)),
                                         ("chignolin", (8,))])
@pytest.mark.parametrize("kind", ["harmonic", "metadynamics"])
def test_bias_kernel_matches_plain_version_on_the_card(name, hidden, kind):
    """Energies and forces to 1e-4 (forces of the largest force), 50 biased
    steps to 1e-3 nm, one launch counted a call. Alanine's 32 threads
    stride over 64 hidden units; chignolin has more threads than units."""
    _need_card()
    system, pos, info, quads = _molecule(name, device="cuda")
    model = _model(len(quads), hidden=hidden, device="cuda")
    R = 8
    x, v, seeds, temps = _md_inputs(system, pos, R)
    hills = _ledger(2, 700, 4096, device="cuda") if kind == "metadynamics" else None
    chunk = build_fused_chunk(
        system, dt=DT, friction=1.0, n_replicas=R, bias_model=model, bias_quads=quads,
        bias_strength=2.0, bias_kind=kind, mtd_sigma=SIGMA if hills is not None else None)
    key = f"bias_{kind}"
    before = fused_md.variant_launches[key]
    ek, fk = chunk.energy_and_forces(x, hills)
    ep, fp = chunk._force_fn(hills)(x)
    assert float((fk - fp).abs().max() / fp.abs().max()) <= 1e-4
    assert float((ek - ep).abs().max() / ep.abs().max()) <= 1e-4
    xk, vk, ek = chunk(x, v, seeds, temps, 50, 0, hills=hills)
    xp, vp, _ = chunk.reference(x, v, seeds, temps, 50, 0, hills=hills)
    torch.cuda.synchronize()
    assert fused_md.variant_launches[key] == before + 2
    assert bool(torch.isfinite(xk).all())
    assert float((xk - xp).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("bias_factor", [None, 8.0], ids=["standard", "well_tempered"])
def test_fused_deposit_kernel_matches_plain_version_on_the_card(bias_factor):
    """The ledger of a launch with deposits inside against the plain
    version's: counts equal, centres 1e-4, heights 1e-4 relative; a ledger
    that fills during the launch stops taking hills."""
    _need_card()
    system, pos, info, quads = _molecule("chignolin", device="cuda")
    model = _model(len(quads), hidden=(64, 64), device="cuda")
    R, interval = 4, 10
    x, v, seeds, temps = _md_inputs(system, pos, R)
    chunk = build_fused_chunk(
        system, dt=DT, friction=1.0, n_replicas=R, bias_model=model, bias_quads=quads,
        bias_kind="metadynamics", mtd_sigma=SIGMA, mtd_deposit_interval=interval,
        mtd_height=1.3, mtd_bias_factor=bias_factor)
    for capacity in (64, 10):
        h0 = MetadynamicsBias(sigma=SIGMA, max_hills=capacity).init_state(2, device="cuda")
        before = fused_md.variant_launches["fused_metadynamics"]
        xk, _, _, hk = chunk(x, v, seeds, temps, 3 * interval, 0, hills=h0)
        xp, _, _, hp = chunk.reference(x, v, seeds, temps, 3 * interval, 0, hills=h0)
        torch.cuda.synchronize()
        assert fused_md.variant_launches["fused_metadynamics"] == before + 1
        n = min(3 * R, capacity)
        assert int(hk.n_hills) == int(hp.n_hills) == n
        assert float((hk.centers - hp.centers).abs().max()) <= 1e-4
        assert float(((hk.heights - hp.heights)[:n] / hp.heights[:n]).abs().max()) <= 1e-4
        assert float((xk - xp).abs().max()) <= 1e-3
        assert int(h0.n_hills) == 0            # the caller's ledger is untouched
