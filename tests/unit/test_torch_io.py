"""Trajectory files, demux and REMD checkpoints across the two packages.

- ``.xtc`` / ``.dcd`` / ``.trr`` / ``.nc`` / ``.npz`` written by the port's
  host copies and read by the JAX package's readers, and the reverse,
  within each codec's precision (xtc 1e-3 nm fixed point, dcd float32 in
  angstrom, nc float32 in angstrom, trr / npz float32 exact); the pure-Python xtc codec where no
  compiler is found; the native codec built under the checkout.
- Demux (mirrors of ``test_workflow_demux.py``).
- A REMD checkpoint of each package read by the other (positions,
  velocities, replica ids, ladder, step, hills); the port refuses a JAX
  checkpoint's PRNG keys without a seed, continues its own streams bit
  for bit, and re-keys them with one.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.io import dcd, trajectory, xtc
from pmarlo_tpu_torch.remd import demux

jax = pytest.importorskip("jax")
jnp = jax.numpy

XTC_QUANT = 0.5e-3 + 1e-6       # half the 1e-3 nm fixed-point step


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 3.0, (6, 40, 3)).astype(np.float32)
    box = np.tile(np.diag([3.0, 3.1, 3.2]).astype(np.float32).reshape(9), (6, 1))
    return x, box


def _write_read(pkg, x, box, tmp_path, fmt):
    """Write ``x`` with package ``pkg``'s io modules; return the path."""
    io = __import__(f"{pkg}.io", fromlist=["xtc", "dcd", "trr", "netcdf", "trajectory"])
    p = tmp_path / f"{pkg}.{fmt}"
    if fmt == "xtc":
        io.xtc.write_xtc(p, x, box_nm=box.reshape(-1, 3, 3))
    elif fmt == "dcd":
        io.dcd.write_dcd(p, x, box=(3.0, 3.1, 3.2))
    elif fmt == "trr":
        io.trr.write_trr(p, x, box_nm=box.reshape(-1, 3, 3))
    elif fmt == "nc":
        io.netcdf.write_netcdf(p, x)
    else:
        with io.trajectory.TrajectoryWriter(p, metadata={"box": [3.0, 3.1, 3.2]}) as w:
            w.write_frames(x)
    return p


TOL = {"xtc": XTC_QUANT, "dcd": 1e-5, "trr": 0.0, "nc": 1e-6, "npz": 0.0}


@pytest.mark.parametrize("fmt", list(TOL))
@pytest.mark.parametrize("writer,reader", [("pmarlo_tpu_torch", "pmarlo_tpu"),
                                           ("pmarlo_tpu", "pmarlo_tpu_torch")],
                         ids=["port_to_jax", "jax_to_port"])
def test_trajectory_files_cross_packages(frames, tmp_path, fmt, writer, reader):
    x, box = frames
    p = _write_read(writer, x, box, tmp_path, fmt)
    io = __import__(f"{reader}.io.trajectory", fromlist=["TrajectoryReader"])
    got = io.TrajectoryReader(p).load()
    assert got.shape == x.shape
    assert np.abs(got - x).max() <= TOL[fmt]
    if fmt == "npz":
        assert io.TrajectoryReader(p).metadata()["box"] == [3.0, 3.1, 3.2]


def test_xtc_python_codec_where_no_compiler(frames, tmp_path, monkeypatch):
    """With no native codec the pure-Python writer and reader give the
    same frames, and the JAX reader decodes them."""
    from pmarlo_tpu.io.xtc import read_xtc as jax_read_xtc

    x, box = frames
    monkeypatch.setattr(xtc, "_lib", None)
    monkeypatch.setattr(xtc, "_native_failed", True)
    p = xtc.write_xtc(tmp_path / "py.xtc", x)
    assert np.abs(xtc.read_xtc(p) - x).max() <= XTC_QUANT
    assert np.abs(jax_read_xtc(p) - x).max() <= XTC_QUANT


def test_native_codec_builds_under_the_checkout(monkeypatch):
    from pmarlo_tpu_torch.io import _native_build

    monkeypatch.delenv("PMARLO_CACHE_DIR", raising=False)
    root = Path(__file__).resolve().parents[2]
    assert _native_build.cache_dir() == root / "build" / "pmarlo_tpu_torch" / "native"
    assert _native_build.NATIVE_DIR == root / "native"
    lib = xtc._load_native()
    if lib is not None:
        assert Path(lib._name).parent == _native_build.cache_dir()


def test_get_writer_dispatch_and_box_trace(frames, tmp_path):
    """The writers ``run_segment`` uses: a per-frame box trace lands in the
    xtc and dcd cells."""
    x, _ = frames
    trace = np.linspace(3.0, 3.3, 6)[:, None] * np.ones(3)
    meta = {"box": [3.0, 3.0, 3.0], "box_trace": trace.tolist(), "dt_ps": 0.002,
            "report_interval": 10}
    for suffix in ("xtc", "dcd", "npz"):
        w = trajectory.get_writer(tmp_path / f"t.{suffix}", metadata=meta)
        w.write_frames(x)
        w.close()
    _, _, _, b = xtc.read_xtc(tmp_path / "t.xtc", return_metadata=True)
    np.testing.assert_allclose(b.reshape(6, 9)[:, 0], trace[:, 0], rtol=1e-6)
    box, _ = dcd.read_dcd_box(tmp_path / "t.dcd")
    assert box[0] == pytest.approx(trace[0, 0], rel=1e-5)
    assert np.abs(dcd.read_dcd(tmp_path / "t.dcd") - x).max() <= 1e-5
    assert trajectory.TrajectoryReader(tmp_path / "t.npz").metadata()["box_trace"] == trace.tolist()


def test_demux_remux_inverse_and_files_match_jax(tmp_path):
    from pmarlo_tpu.remd import demux as jdemux

    rng = np.random.default_rng(0)
    F, R, N = 12, 4, 5
    rung_frames = rng.normal(size=(F, R, N, 3)).astype(np.float32)
    ids = np.asarray([np.arange(R)] + [rng.permutation(R) for _ in range(4)])
    replica_frames = demux.remux_frames(rung_frames, ids, frames_per_attempt=3)
    np.testing.assert_array_equal(
        replica_frames, jdemux.remux_frames(rung_frames, ids, frames_per_attempt=3))
    back = demux.demux_frames(replica_frames, ids, frames_per_attempt=3)
    np.testing.assert_array_equal(back, rung_frames)

    files = []
    for r in range(R):
        p = tmp_path / f"replica_{r}.npz"
        with trajectory.TrajectoryWriter(p) as w:
            w.write_frames(replica_frames[:, r])
        files.append(p)
    out = demux.demux_trajectory_files(files, ids, [300.0, 320.0, 340.0, 360.0],
                                       tmp_path / "demux", frames_per_attempt=3)
    jout = jdemux.demux_trajectory_files(files, ids, [300.0, 320.0, 340.0, 360.0],
                                         tmp_path / "jdemux", frames_per_attempt=3)
    assert len(out) == len(jout) == R
    for a, b, r in zip(out, jout, range(R)):
        np.testing.assert_array_equal(trajectory.TrajectoryReader(a).load(), rung_frames[:, r])
        np.testing.assert_array_equal(trajectory.TrajectoryReader(b).load(), rung_frames[:, r])


# --- REMD checkpoints ----------------------------------------------------------------


@pytest.fixture(scope="module")
def alanine():
    from pmarlo_tpu.data import alanine_dipeptide_structure
    from pmarlo_tpu.md.forcefield import build_system
    from pmarlo_tpu_torch.md.system import system_from_numpy

    js, jx = build_system(alanine_dipeptide_structure())
    return js, system_from_numpy(js.to_dict(), device="cpu"), np.asarray(jx, np.float32)


def _port_remd(system, x, seed=9):
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    cfg = RemdConfig(n_replicas=4, t_min=300.0, t_max=500.0, exchange_frequency=50,
                     report_interval=50, seed=seed)
    return ReplicaExchange(system, torch.tensor(x), cfg, device="cpu", minimize=False)


def test_port_checkpoint_reads_in_jax_and_continues_bitwise(alanine, tmp_path):
    from pmarlo_tpu.remd.checkpoint import load_checkpoint as jax_load
    from pmarlo_tpu_torch.bias.metadynamics import MetadynamicsBias
    from pmarlo_tpu_torch.remd.checkpoint import load_checkpoint, save_checkpoint

    js, system, x = alanine
    remd = _port_remd(system, x)
    remd.run(200)
    mtd = MetadynamicsBias(sigma=(0.1,), max_hills=16)
    hills = mtd.deposit(mtd.init_state(1, device="cpu"), torch.tensor([0.5]))
    path = save_checkpoint(remd, tmp_path / "ck.npz", hills=hills, extra={"round": 1})

    jremd, jhills, extra = jax_load(path, js)
    assert extra == {"round": 1}
    np.testing.assert_array_equal(np.asarray(jremd.state.positions), remd.state.positions.numpy())
    np.testing.assert_array_equal(np.asarray(jremd.state.velocities),
                                  remd.state.velocities.numpy())
    np.testing.assert_array_equal(np.asarray(jremd.replica_ids), remd.replica_ids.numpy())
    np.testing.assert_allclose(np.asarray(jremd.ladder), remd.ladder.numpy(), rtol=1e-6)
    assert remd.state.step == 200 and (np.asarray(jremd.state.step) == 200).all()
    assert int(jhills.n_hills) == 1
    np.testing.assert_array_equal(np.asarray(jhills.centers), hills.centers.numpy())
    # the keys JAX reads are PRNGKey(seed) of the port's seeds
    np.testing.assert_array_equal(np.asarray(jremd.state.key)[:, 1],
                                  remd.state.seeds.numpy().astype(np.uint32))

    remd2, hills2, _ = load_checkpoint(path, system)
    assert int(hills2.n_hills) == 1 and torch.equal(hills2.heights, hills.heights)
    assert remd2._attempts_done == remd._attempts_done == 4
    r1, r2 = remd.run(100), remd2.run(100)
    np.testing.assert_array_equal(r1.positions, r2.positions)
    np.testing.assert_array_equal(r1.replica_ids, r2.replica_ids)
    remd3, _, _ = load_checkpoint(path, system, seed=5)
    assert not torch.equal(remd3.state.seeds, remd2.state.seeds)
    with pytest.raises(ValueError, match="physics modes"):
        load_checkpoint(path, system, constraints=object())


def test_jax_checkpoint_needs_a_seed_in_the_port(alanine, tmp_path):
    from pmarlo_tpu.bias.metadynamics import MetadynamicsBias as JaxMtd
    from pmarlo_tpu.remd.checkpoint import save_checkpoint as jax_save
    from pmarlo_tpu.remd.remd import RemdConfig as JaxConfig
    from pmarlo_tpu.remd.remd import ReplicaExchange as JaxRemd
    from pmarlo_tpu_torch.remd.checkpoint import load_checkpoint

    js, system, x = alanine
    cfg = JaxConfig(n_replicas=4, t_min=300.0, t_max=500.0, exchange_frequency=50,
                    report_interval=50, seed=9)
    jremd = JaxRemd(js, jnp.asarray(x), cfg, minimize=False)
    mtd = JaxMtd(sigma=(0.1,), max_hills=16)
    jhills = mtd.deposit(mtd.init_state(1), jnp.asarray([0.5], jnp.float32))
    path = jax_save(jremd, tmp_path / "jck.npz", hills=jhills)
    with pytest.raises(ValueError, match="seed="):
        load_checkpoint(path, system)
    remd, hills, _ = load_checkpoint(path, system, seed=3)
    np.testing.assert_array_equal(remd.state.positions.numpy(), np.asarray(jremd.state.positions))
    np.testing.assert_array_equal(remd.state.velocities.numpy(),
                                  np.asarray(jremd.state.velocities))
    np.testing.assert_array_equal(remd.replica_ids.numpy(), np.asarray(jremd.replica_ids))
    np.testing.assert_allclose(remd.ladder.numpy(), np.asarray(jremd.ladder), rtol=1e-6)
    assert remd.state.step == 0 and remd.config.seed == 3 and remd._attempts_done == 0
    assert int(hills.n_hills) == 1
    np.testing.assert_array_equal(hills.centers.numpy(), np.asarray(jhills.centers))
    res = remd.run(50)
    assert np.isfinite(res.positions).all()
