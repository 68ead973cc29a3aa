"""Names the port carries for the JAX package's users, each against JAX:

* ``DeepTICAModel.to_torchscript`` and ``plumed_snippet``
  (``ml/plumed.py``), the mirror of ``test_plumed_export.py``: a JAX model
  and its port (the same weights through ``deeptica_from_numpy``) export
  TorchScript files whose outputs agree within 1e-6, with and without the
  output whitening and the layer norm, and give the same snippet;
* ``features.builtins.align_to_reference``: the Kabsch superposition of a
  trajectory (rotations and a reflected frame) against JAX's at 1e-5 nm;
* ``md.load_amber_files`` (``md/amber_params.py``, a host copy), the
  mirror of ``test_amber_params.py``: the lazy export, and the tables it
  installs equal to JAX's, end to end through ``build_system``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.ml.deeptica import deeptica_from_numpy


def _models(whiten: bool, layernorm: bool):
    """(JAX model, its port) with the same weights."""
    import jax
    from pmarlo_tpu.ml.deeptica import DeepTICAConfig, DeepTICAModel, init_mlp_params

    rng = np.random.default_rng(0)
    cfg = DeepTICAConfig(n_out=2, hidden=(16, 16), activation="tanh", layernorm=layernorm)
    params = init_mlp_params(jax.random.PRNGKey(0), 6, cfg.hidden, cfg.n_out)
    whitening = ({"mean": rng.normal(size=2), "transform": rng.normal(size=(2, 2))}
                 if whiten else None)
    jm = DeepTICAModel(config=cfg, params=params, scaler_mean=rng.normal(size=6),
                       scaler_scale=rng.uniform(0.5, 2.0, size=6), whitening=whitening)
    tm = deeptica_from_numpy(
        dataclasses.asdict(cfg),
        [{k: np.asarray(v) for k, v in layer.items()} for layer in params],
        jm.scaler_mean, jm.scaler_scale, whitening, device="cpu")
    return jm, tm


@pytest.mark.parametrize("whiten", [True, False], ids=["whitened", "raw"])
@pytest.mark.parametrize("layernorm", [True, False], ids=["layernorm", "plain"])
def test_torchscript_export_matches_jax(tmp_path, whiten, layernorm):
    jm, tm = _models(whiten, layernorm)
    out = tm.to_torchscript(tmp_path / "port" / "cv.pt")
    jout = jm.to_torchscript(tmp_path / "jax" / "cv.pt")
    assert out.suffix == ".ts" and out.exists() and jout.exists()
    X = np.random.default_rng(1).normal(size=(40, 6)).astype(np.float32)
    got = torch.jit.load(str(out))(torch.tensor(X)).detach().numpy()
    want = torch.jit.load(str(jout))(torch.tensor(X)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, tm.transform(X), rtol=0, atol=1e-6)


def test_plumed_snippet_matches_jax(tmp_path):
    from pmarlo_tpu.ml.plumed import plumed_snippet as jax_snippet

    from pmarlo_tpu_torch.ml.plumed import plumed_snippet

    jm, tm = _models(True, True)
    snippet = tm.plumed_snippet(tmp_path / "cv.pt")
    assert snippet == jax_snippet(jm, tmp_path / "cv.pt") == plumed_snippet(tm, "cv.pt")
    lines = snippet.strip().splitlines()
    assert lines == ["PYTORCH_MODEL FILE=cv.ts LABEL=mlcv", "CV VALUE=mlcv.node-0",
                     "CV VALUE=mlcv.node-1"]


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def test_align_to_reference_matches_jax():
    import jax.numpy as jnp
    from pmarlo_tpu.features.builtins import align_to_reference as jax_align

    from pmarlo_tpu_torch.features.builtins import align_to_reference

    rng = np.random.default_rng(2)
    ref = rng.normal(0.0, 0.5, (22, 3))
    rot = _rotations(rng, 6)
    frames = (np.einsum("tij,nj->tni", rot, ref) + rng.normal(0.0, 0.02, (6, 22, 3))
              + rng.normal(0.0, 2.0, (6, 1, 3)))
    frames[3] *= np.array([1.0, 1.0, -1.0])          # a mirror image
    frames, ref = frames.astype(np.float32), ref.astype(np.float32)
    got = align_to_reference(torch.tensor(frames), torch.tensor(ref)).numpy()
    want = np.asarray(jax_align(jnp.asarray(frames), jnp.asarray(ref)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the rotated frames land on the centred reference
    centred = ref - ref.mean(0)
    for t in (0, 1, 2, 4, 5):
        assert np.abs(got[t] - centred).max() < 0.1
    # one frame without the frame axis
    one = align_to_reference(frames[0], ref).numpy()
    np.testing.assert_allclose(one[0], got[0], atol=1e-6)


FRCMOD_REFIT = "psi refit\nDIHE\nN -CT-C -N    1    2.50        180.0          1.\n\nEND\n"


def test_load_amber_files_is_a_lazy_md_export():
    import pmarlo_tpu_torch.md as tmd

    assert "load_amber_files" in tmd.__all__
    assert callable(tmd.load_amber_files)


def test_load_amber_files_installs_the_tables_of_jax(tmp_path):
    from pmarlo_tpu.md import amber_params as jap
    from pmarlo_tpu.md import ff_params as jff
    from pmarlo_tpu.md import residues as jres

    import pmarlo_tpu_torch.md as tmd
    from pmarlo_tpu_torch.md import amber_params as tap
    from pmarlo_tpu_torch.md import ff_params as tff
    from pmarlo_tpu_torch.md import residues as tres
    from tests.unit.test_amber_params import FRCMOD, OFF_LIB

    f1 = tmp_path / "frcmod.refit"
    f1.write_text(FRCMOD)
    f2 = tmp_path / "mini.lib"
    f2.write_text(OFF_LIB)
    with tap.parameter_snapshot(), jap.parameter_snapshot():
        summary = tmd.load_amber_files(str(f1), str(f2))
        assert summary == jap.load_amber_files(str(f1), str(f2))
        assert summary["residues"] == ["QLG"]
        for table in ("TYPE_MASSES", "TYPE_ELEMENTS", "TYPE_LJ"):
            assert getattr(tff, table)["Q1"] == getattr(jff, table)["Q1"], table
        assert tff.lookup_bond("Q1", "CT") == jff.lookup_bond("Q1", "CT")
        assert tff.lookup_angle("CT", "CT", "Q1") == jff.lookup_angle("CT", "CT", "Q1")
        assert (tff.lookup_dihedral("HC", "Q1", "CT", "HC")
                == jff.lookup_dihedral("HC", "Q1", "CT", "HC"))
        assert tres.get_template("QLG") == jres.get_template("QLG")
    assert "Q1" not in tff.TYPE_MASSES and "QLG" not in tres.TEMPLATES


def test_torsion_refit_changes_the_built_system_as_in_jax():
    from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
    from pmarlo_tpu.md import amber_params as jap
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md import amber_params as tap
    from pmarlo_tpu_torch.md.forcefield import build_system

    with tap.parameter_snapshot(), jap.parameter_snapshot():
        tap.install_parameters(tap.parse_frcmod(FRCMOD_REFIT))
        jap.install_parameters(jap.parse_frcmod(FRCMOD_REFIT))
        ts, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")
        js, _ = jax_build_system(jax_alanine(), gb_model="gbn2")
    np.testing.assert_allclose(ts.torsion_k.numpy(), np.asarray(js.torsion_k), rtol=1e-6)
    np.testing.assert_array_equal(ts.torsion_idx.numpy(), np.asarray(js.torsion_idx))
    base, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")
    assert ts.torsion_k.shape[0] < base.torsion_k.shape[0]
