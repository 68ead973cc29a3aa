"""``pmarlo_tpu_torch.parallel`` against ``pmarlo_tpu.parallel``: the mesh
helpers, the three ``sharded_*`` reductions and the data-parallel DeepTICA
step, over 2 and 4 real gloo ranks on the CPU (spawned once per world
size, ``torch_parallel_workers.py``).

JAX runs in this process on the 8-device virtual CPU mesh that
``tests/conftest.py`` provides. Inputs are made with numpy from a seed.
Tolerances: counts and unit-weight histograms exact, weighted histograms
and moments 1e-5 relative; the SGD(lr=1) step's loss 1e-4 and parameters
atol 5e-6 / rtol 1e-5 (``tests/unit/test_parallel_train.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmarlo_tpu.ml.deeptica import DeepTICAConfig, mlp_apply
from pmarlo_tpu.ml.losses import vamp2_loss
from pmarlo_tpu.msm.counting import counts_from_dtrajs
from pmarlo_tpu.parallel import (
    replica_mesh as jax_replica_mesh,
    sharded_covariance_moments as jax_moments,
    sharded_histogram as jax_histogram,
    sharded_transition_counts as jax_counts,
)
from pmarlo_tpu_torch.parallel import data_mesh, replica_mesh, shard_replicas
from torch_parallel_workers import spawn


def _inputs():
    rng = np.random.default_rng(0)
    dtrajs = rng.integers(0, 5, size=(8, 200))
    dtrajs[0, 10] = -1                     # an invalid frame
    dtrajs[5, 50] = 7                      # a label past n_states
    X = rng.normal(size=(8, 100, 3)).astype(np.float32)
    values = rng.normal(size=(8, 500)).astype(np.float32)
    values[3, :4] = (-3.0, 3.0, -3.5, 3.5)   # both edges and both sides
    weights = rng.uniform(0.1, 2.0, size=(8, 500)).astype(np.float32)
    n = 1024
    slow = np.cumsum(rng.normal(0, 0.1, n + 5)).astype(np.float32)
    z0 = np.stack([slow[:n], rng.normal(0, 1, n).astype(np.float32), 0.5 * slow[:n]], 1)
    zt = np.stack([slow[5:], rng.normal(0, 1, n).astype(np.float32), 0.5 * slow[5:]], 1)
    params = [{"w": rng.normal(0.0, np.sqrt(2.0 / (a + b)), (a, b)).astype(np.float32),
               "b": np.zeros(b, np.float32)} for a, b in ((3, 16), (16, 2))]
    return dict(dtrajs=dtrajs, X=X, values=values, weights=weights,
                edges=np.linspace(-3, 3, 25), z0=z0, zt=zt, params=params,
                pairs_train=(z0, zt))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request, inputs, tmp_path_factory):
    world = request.param
    return world, spawn("estimation", world, tmp_path_factory.mktemp(f"est{world}"), **inputs)


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh (conftest sets it)")
    return jax_replica_mesh(8, axis="shard")


def test_a_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="no process group"):
        replica_mesh()
    with pytest.raises(ValueError, match="no process group"):
        data_mesh(2, device_type="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        shard_replicas(np.zeros((4, 3)), object())


def test_mesh_helpers(ranks):
    world, res = ranks
    full = np.arange(4 * world * 3).reshape(4 * world, 3)
    for r, out in enumerate(res):
        assert out["rank"] == r
        assert out["axis"] == ("shard",) and out["replica_axis"] == ("replica",)
        assert "whole world" in out["wrong_size"]
        np.testing.assert_array_equal(out["block"], full[4 * r:4 * (r + 1)])
        assert "does not divide" in out["indivisible"]
        assert "not 'replica'" in out["wrong_axis"]


def test_counts_match_jax_and_serial(ranks, inputs, jax_mesh):
    _, res = ranks
    d = inputs["dtrajs"]
    ref = counts_from_dtrajs([np.where(r < 5, r, -1) for r in d], 3, 5)
    jx = jax_counts(d, 3, 5, jax_mesh)
    for out in res:
        assert out["counts"].dtype == np.float64
        np.testing.assert_array_equal(out["counts"], jx)
        np.testing.assert_array_equal(out["counts"], ref)


def test_moments_match_jax_and_serial(ranks, inputs, jax_mesh):
    from pmarlo_tpu.msm.reduction import _streaming_moments

    _, res = ranks
    X = inputs["X"]
    jx = jax_moments(X, 5, jax_mesh)
    C00r, C0tr, Cttr, nr = _streaming_moments([x for x in X], 5)
    for out in res:
        C00, C0t, Ctt, mean0, meant, n = out["moments"]
        assert n == jx[5] == nr
        for mine, theirs in zip((C00, C0t, Ctt, mean0, meant), jx[:5]):
            np.testing.assert_allclose(mine, theirs, rtol=1e-5,
                                       atol=1e-5 * np.abs(theirs).max())
        for mine, serial in zip((C00, C0t, Ctt), (C00r, C0tr, Cttr)):
            np.testing.assert_allclose(mine, serial, rtol=1e-5, atol=1e-5)


def test_histograms_match_jax_and_serial(ranks, inputs, jax_mesh):
    _, res = ranks
    v, w, edges = inputs["values"], inputs["weights"], inputs["edges"]
    jx = jax_histogram(v, edges, jax_mesh)
    jw = jax_histogram(v, edges, jax_mesh, weights=w)
    flat = v.reshape(-1)
    keep = (flat >= edges[0]) & (flat <= edges[-1])
    serial_w = np.histogram(flat[keep], bins=edges.astype(np.float32),
                            weights=w.reshape(-1)[keep].astype(np.float64))[0]
    for out in res:
        np.testing.assert_array_equal(out["hist"], jx)
        assert out["hist"].sum() == keep.sum()
        np.testing.assert_allclose(out["hist_w"], jw, rtol=1e-5)
        np.testing.assert_allclose(out["hist_w"].sum(), serial_w.sum(), rtol=1e-5)


def _jax_serial_step(params, z0, zt):
    cfg = DeepTICAConfig(lag=5, n_out=2, hidden=(16,), seed=0)
    tx = optax.sgd(1.0)

    def loss_fn(p):
        y0 = mlp_apply(p, z0, cfg.activation, cfg.layernorm)
        yt = mlp_apply(p, zt, cfg.activation, cfg.layernorm)
        return vamp2_loss(y0, yt, ridge=cfg.vamp_ridge, alpha=cfg.vamp_alpha)

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates), loss


def test_data_parallel_step_matches_jax_serial_step(ranks, inputs):
    """SGD(lr=1): the new parameters are the old less the gradient, so
    parameter parity is gradient parity (n times the gradient, or a rank's
    own share of it, would show)."""
    _, res = ranks
    params = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in inputs["params"]]
    p_sr, loss_sr = _jax_serial_step(params, jnp.asarray(inputs["z0"]),
                                     jnp.asarray(inputs["zt"]))
    for out in res:
        assert abs(out["dp_loss"] - float(loss_sr)) < 1e-4
        for mine, theirs in zip(out["dp_params"], p_sr):
            for k in ("w", "b"):
                np.testing.assert_allclose(mine[k], np.asarray(theirs[k]),
                                           atol=5e-6, rtol=1e-5)
    for out in res[1:]:
        for a, b in zip(out["dp_params"], res[0]["dp_params"]):
            np.testing.assert_array_equal(a["w"], b["w"])


def test_data_parallel_training_reduces_loss(ranks):
    _, res = ranks
    losses = res[0]["train_losses"]
    assert losses[-1] < losses[0]
    assert losses[-1] < -0.2
    for out in res[1:]:
        assert out["train_losses"] == losses
