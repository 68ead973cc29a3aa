"""The neighbor-listed GB path (``md/nblist.py``) against the JAX package's.

The same seeded numpy positions go through both packages on the CPU:
alanine in OBC2 and GBn2 (the fixture of ``test_nblist.py``) and the
138-atom chignolin in GBn2. Tolerances: energies to 1e-5 relative with a
1e-3 kJ/mol floor (as ``test_torch_pair_culled.py``: the GB energy of
alanine is a ~-50 kJ/mol total of ~10^3 kJ/mol terms), Born radii to 1e-5
of the largest, forces to 1e-4 of the largest force (float32 sums taken in
another order), positions after 40 friction-0 steps to 1e-5 nm. The
nblist path against the culled pair path (both truncate every pair term at
the cutoff) is held at 1e-4, the card's parity gate.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.md import forces
from pmarlo_tpu_torch.md import nblist as NB
from pmarlo_tpu_torch.md.integrate import MDState
from pmarlo_tpu_torch.md.system import system_from_numpy

jax = pytest.importorskip("jax")
jnp = jax.numpy

STRUCTURES = {
    "alanine_obc2": (alanine_dipeptide_structure, "obc2"),
    "alanine_gbn2": (alanine_dipeptide_structure, "gbn2"),
    "chignolin_gbn2": (chignolin_structure, "gbn2"),
}


def _jax_structure(s):
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure

    return PDBStructure(residues=[PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues])


@pytest.fixture(scope="module")
def systems():
    """JAX system, the port's from its fields, and float32 positions 0.01 nm
    off the structure's (seeded numpy), by name."""
    from pmarlo_tpu.md.forcefield import build_system

    cache = {}

    def get(name):
        if name not in cache:
            make, gb = STRUCTURES[name]
            js, jx = build_system(_jax_structure(make()), gb_model=gb)
            ts = system_from_numpy(js.to_dict(), device="cpu")
            rng = np.random.default_rng(21)
            x = (np.asarray(jx) + rng.normal(0.0, 0.01, np.shape(jx))).astype(np.float32)
            cache[name] = (js, ts, x)
        return cache[name]

    return get


def _lists(x, cutoff, capacity):
    from pmarlo_tpu.md import nblist as JNB

    return (JNB.build_neighbor_list(jnp.asarray(x), cutoff, capacity),
            NB.build_neighbor_list(torch.from_numpy(x), cutoff, capacity))


def _rows(idx, mask):
    return [set(int(j) for j, m in zip(r, mr) if m) for r, mr in zip(idx, mask)]


def _close_energy(te, je, rel=1e-5):
    te, je = float(te), float(je)
    assert abs(te - je) <= max(rel * abs(je), 1e-3), (te, je)


def _close_forces(tf, jf, rel=1e-4):
    tf, jf = np.asarray(tf), np.asarray(jf)
    assert np.abs(tf - jf).max() <= rel * np.abs(jf).max()


# --- the list and the tables -----------------------------------------------------------

@pytest.mark.parametrize("name,cutoff,capacity", [
    ("alanine_gbn2", 0.5, 22), ("alanine_gbn2", 50.0, 22),
    ("chignolin_gbn2", 1.2, 137), ("chignolin_gbn2", 0.8, 64),
    # overflow: rows saturate at their capacity nearest partners
    ("alanine_gbn2", 50.0, 4), ("chignolin_gbn2", 1.2, 16),
], ids=["alanine_0.5", "alanine_beyond", "chignolin_1.2", "chignolin_0.8",
        "alanine_overflow", "chignolin_overflow"])
def test_neighbor_list_partners_match_jax(systems, name, cutoff, capacity):
    _, _, x = systems(name)
    jnl, tnl = _lists(x, cutoff, capacity)
    n = x.shape[0]
    assert tuple(tnl.idx.shape) == tuple(jnl.idx.shape) == (n, min(capacity, n))
    assert tnl.mask.dtype == torch.float32
    jidx, jmask = np.asarray(jnl.idx), np.asarray(jnl.mask)
    tidx, tmask = tnl.idx.numpy(), tnl.mask.numpy()
    assert _rows(tidx, tmask) == _rows(jidx, jmask)
    np.testing.assert_array_equal(tmask.sum(1), jmask.sum(1))
    assert int(tnl.n_max) == int(jnl.n_max)
    assert tnl.n_max.dtype == torch.int32
    # empty slots point at their own row
    rows = np.broadcast_to(np.arange(n)[:, None], tidx.shape)
    assert (tidx[tmask == 0] == rows[tmask == 0]).all()
    # valid slots are within the cutoff and both directions are listed
    d = np.linalg.norm(x[:, None, :] - x[tidx], axis=-1)
    assert (d[tmask == 1] < cutoff).all()
    if int(tnl.n_max) <= capacity:
        pairs = {(i, j) for i, r in enumerate(_rows(tidx, tmask)) for j in r}
        assert all((j, i) in pairs for i, j in pairs)
    else:
        assert (tmask.sum(1) <= capacity).all() and int(tnl.n_max) > capacity


def test_list_rows_in_chunks_match_one_chunk(systems, monkeypatch):
    """A list built in row chunks is the list of a single chunk."""
    _, _, x = systems("chignolin_gbn2")
    whole = NB.build_neighbor_list(torch.from_numpy(x), 1.0, 40)
    monkeypatch.setattr(NB, "_BUILD_CHUNK_ENTRIES", 7 * x.shape[0])
    parts = NB.build_neighbor_list(torch.from_numpy(x), 1.0, 40)
    assert torch.equal(whole.idx, parts.idx) and torch.equal(whole.mask, parts.mask)
    assert int(whole.n_max) == int(parts.n_max)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_exclusion_tables_match_jax(systems, name):
    from pmarlo_tpu.md import nblist as JNB

    js, ts, _ = systems(name)
    jt = JNB.make_exclusion_tables(js)
    tt = NB.make_exclusion_tables(ts)
    for field in jt._fields:
        np.testing.assert_array_equal(getattr(tt, field).numpy(), np.asarray(getattr(jt, field)),
                                      err_msg=field)
    assert tt.partner.dtype == torch.int64
    # the copied host loop, held against its source
    arrays = NB._exclusion_table_arrays(np.asarray(js.excl12_idx), np.asarray(js.pair14_idx),
                                        js.n_atoms)
    for got, want in zip(arrays, jt):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))


def test_tables_need_the_exclusion_lists(systems):
    import dataclasses

    _, ts, _ = systems("alanine_gbn2")
    with pytest.raises(ValueError, match="exclusion index lists"):
        NB.make_exclusion_tables(dataclasses.replace(ts, excl12_idx=None))


# --- energies and forces ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_terms(systems):
    """JAX's four energy functions and the gradient of the total, jitted
    once a system (the list's shape is the same at both cutoffs)."""
    from pmarlo_tpu.md import nblist as JNB

    cache = {}

    def get(name):
        if name not in cache:
            js = systems(name)[0]
            jt = JNB.make_exclusion_tables(js)

            def terms(p, nl):
                return (JNB.nonbonded_energy_nb(js, p, nl, jt), JNB.born_radii_nb(js, p, nl),
                        JNB.gb_energy_nb(js, p, nl),
                        jax.value_and_grad(lambda q: JNB.potential_energy_nb(js, q, nl, jt))(p))

            cache[name] = jax.jit(terms)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(STRUCTURES))
@pytest.mark.parametrize("cutoff", [1.2, 50.0], ids=["rc1.2", "beyond"])
def test_energies_and_forces_match_jax(systems, jax_terms, name, cutoff):
    js, ts, x = systems(name)
    n = x.shape[0]
    jnl, tnl = _lists(x, cutoff, n)
    tt = NB.make_exclusion_tables(ts)
    tx = torch.from_numpy(x)
    j_nb, jb, j_gb, (je, jg) = jax_terms(name)(jnp.asarray(x), jnl)
    _close_energy(NB.nonbonded_energy_nb(ts, tx, tnl, tt), j_nb)
    jb, tb = np.asarray(jb), NB.born_radii_nb(ts, tx, tnl).numpy()
    assert np.abs(tb - jb).max() <= 1e-5 * np.abs(jb).max()
    _close_energy(NB.gb_energy_nb(ts, tx, tnl), j_gb)
    _close_energy(NB.potential_energy_nb(ts, tx, tnl, tt), je)
    _close_energy(NB.potential_energy_nb(ts, tx, tnl), je)           # tables built inside
    y = tx.clone().requires_grad_(True)
    (tg,) = torch.autograd.grad(NB.potential_energy_nb(ts, y, tnl, tt), y)
    _close_forces(-tg.numpy(), -np.asarray(jg))


@pytest.mark.parametrize("name", ["alanine_obc2", "alanine_gbn2", "chignolin_gbn2"])
def test_beyond_the_extent_matches_the_dense_path(systems, name):
    """A cutoff past the system's extent lists every pair: the dense
    potential and its forces."""
    _, ts, x = systems(name)
    tx = torch.from_numpy(x)
    nl = NB.build_neighbor_list(tx, 50.0, x.shape[0])
    e, f = NB._energy_and_forces(ts, tx, nl, NB._pair_scales(nl, NB.make_exclusion_tables(ts)),
                                 None)
    _close_energy(e, forces.potential_energy(ts, tx))
    _close_forces(f, forces.compute_forces(ts, tx))


def test_bias_fn_adds_to_the_energy(systems):
    _, ts, x = systems("alanine_gbn2")
    tx = torch.from_numpy(x)
    nl = NB.build_neighbor_list(tx, 1.0, 21)
    e0 = NB.potential_energy_nb(ts, tx, nl)
    e1 = NB.potential_energy_nb(ts, tx, nl, bias_fn=lambda p: 10.0 * (p[..., 1, 0] - 0.3) ** 2)
    assert float(e1 - e0) == pytest.approx(10.0 * (x[1, 0] - 0.3) ** 2, rel=1e-3)


# --- the MD loop ---------------------------------------------------------------------

@pytest.mark.parametrize("rebuild", [10, 20])
def test_run_md_nb_matches_jax_step_for_step(systems, rebuild):
    """40 steps at friction 0 (no noise enters) from the same positions and
    velocities, the list at 0.6 + 0.1 nm rebuilt every 10 or 20 steps.
    Positions to 1e-5 nm; the frames' energies and temperatures to 2e-5
    relative, not 1e-5: they are read at positions the two float32
    trajectories reach ~1e-6 nm apart, which moves a ~500 kJ/mol energy by
    up to 6e-3 kJ/mol (1.2e-5 relative at the 40th step)."""
    from pmarlo_tpu.md import nblist as JNB
    from pmarlo_tpu.md.integrate import MDState as JState

    js, ts, x = systems("alanine_gbn2")
    v = np.random.default_rng(22).normal(0.0, 0.3, x.shape).astype(np.float32)
    kw = dict(n_steps=40, dt=0.002, friction=0.0, temperature_K=300.0, report_interval=20,
              cutoff=0.6, skin=0.1, capacity=16, rebuild_interval=rebuild)
    jst, jfr = JNB.run_md_nb(js, JState(positions=jnp.asarray(x), velocities=jnp.asarray(v),
                                        key=jax.random.PRNGKey(0), step=jnp.int32(0)), **kw)
    tst, tfr = NB.run_md_nb(ts, MDState(positions=torch.from_numpy(x),
                                        velocities=torch.from_numpy(v),
                                        seeds=torch.zeros((), dtype=torch.int32)), **kw)
    assert set(tfr) == set(jfr) == {"positions", "potential_energy", "temperature"}
    assert tuple(tfr["positions"].shape) == (2,) + x.shape
    np.testing.assert_allclose(tfr["positions"].numpy(), np.asarray(jfr["positions"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tfr["potential_energy"].numpy(),
                               np.asarray(jfr["potential_energy"]), rtol=2e-5)
    np.testing.assert_allclose(tfr["temperature"].numpy(), np.asarray(jfr["temperature"]),
                               rtol=2e-5)
    np.testing.assert_allclose(tst.positions.numpy(), np.asarray(jst.positions), atol=1e-5, rtol=0)
    _close_forces(tst.velocities.numpy(), np.asarray(jst.velocities))    # 1e-4 of the largest
    assert tst.step == 40


def test_run_md_nb_thermostat_runs(systems):
    """Friction 1/ps from Maxwell-Boltzmann velocities at minimized
    positions: finite frames and a temperature in the JAX test's window."""
    from pmarlo_tpu_torch.md.integrate import thermalize
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    _, ts, x = systems("alanine_gbn2")
    x_min, _ = minimize_energy(ts, torch.from_numpy(x))
    st = thermalize(ts, x_min, torch.Generator().manual_seed(1), 300.0)
    st, rep = NB.run_md_nb(ts, st, n_steps=100, dt=0.002, friction=1.0, temperature_K=300.0,
                           report_interval=50, cutoff=1.2, rebuild_interval=25)
    assert torch.isfinite(rep["positions"]).all()
    assert 150.0 < float(rep["temperature"][-1]) < 450.0


def test_run_md_nb_validates_its_arguments(systems):
    _, ts, x = systems("alanine_gbn2")
    st = MDState(positions=torch.from_numpy(x), velocities=torch.zeros_like(torch.from_numpy(x)),
                 seeds=torch.zeros((), dtype=torch.int32))
    kw = dict(dt=0.002, friction=1.0, temperature_K=300.0)
    with pytest.raises(ValueError, match="rebuild_interval"):
        NB.run_md_nb(ts, st, n_steps=100, report_interval=100, rebuild_interval=33, **kw)
    with pytest.raises(ValueError, match="report_interval"):
        NB.run_md_nb(ts, st, n_steps=150, report_interval=100, rebuild_interval=20, **kw)
    batched = MDState(positions=st.positions[None], velocities=st.velocities[None],
                      seeds=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="one system"):
        NB.run_md_nb(ts, batched, n_steps=20, report_interval=20, **kw)


def test_default_capacity_is_jax_formula():
    assert NB._default_capacity(3726, 2.0, 0.2) == min(3725, max(64, int(120 * 2.2 ** 3)))
    assert NB._default_capacity(22, 2.0, 0.2) == 21
    assert NB._default_capacity(5000, 0.5, 0.1) == 64


# --- against the culled pair path ------------------------------------------------------

@pytest.fixture(scope="module")
def culled_reference(systems):
    """Chignolin at a 1.5 nm cutoff: the nblist path (list without skin) and
    JAX's culled Newton pair path in interpret mode."""
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, ts, x = systems("chignolin_gbn2")
    tx = torch.from_numpy(x)
    nl = NB.build_neighbor_list(tx, 1.5, x.shape[0])
    assert float(nl.mask.sum()) < x.shape[0] * (x.shape[0] - 1)      # the cutoff cuts
    e, f = NB._energy_and_forces(ts, tx, nl, NB._pair_scales(nl, NB.make_exclusion_tables(ts)),
                                 None)
    je, jf = jax_pair(js, tile=128, gb_cutoff=1.5, interpret=True)(jnp.asarray(x))
    return ts, tx, e, f, float(je), np.asarray(jf)


@pytest.mark.parametrize("newton", [True, False], ids=["newton", "ordered"])
def test_nblist_matches_the_culled_pair_path(culled_reference, newton):
    """Both truncate LJ, Coulomb, the GB cross term, the Born integral and
    the neck at r > cutoff: the port's plain pair sweeps (Newton and
    ordered) and JAX's Pallas path agree with the nblist path at 1e-4."""
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    ts, tx, e, f, je, jf = culled_reference
    pe, pf = build_pair_force_fn(ts, gb_cutoff=1.5, newton=newton)(tx)
    _close_energy(e, pe, rel=1e-4)
    _close_forces(f, pf, rel=1e-4)
    _close_energy(e, je, rel=1e-4)
    _close_forces(f, jf, rel=1e-4)
