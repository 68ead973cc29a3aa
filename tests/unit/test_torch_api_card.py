"""The API facade's device code on the card, against the same calls on the
CPU (this file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_api_card.py``).

``compute_features``, ``align_trajectory``, ``trig_expand_periodic`` and
``compute_universal_embedding`` compute on the card when given no device,
from a host array and from a CUDA tensor, and hand back host numpy (the
CUDA-tensor-to-numpy step no CPU test exercises) within 1e-5 of
``device="cpu"``; ``cluster_microstates`` runs k-means on the card and
gives the CPU's partition up to relabelling.
"""

import numpy as np
import pytest
import torch

import pmarlo_tpu_torch  # noqa: F401  (pins float32 matmuls)
from pmarlo_tpu_torch import api
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.features.base import TopologyInfo
from pmarlo_tpu_torch.md.topology import build_topology


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the features and k-means run on it")
    api.clear_feature_cache()
    yield torch.device("cuda")
    api.clear_feature_cache()


@pytest.fixture(scope="module")
def frames():
    s = chignolin_structure()
    rng = np.random.default_rng(11)
    x0 = s.coordinates()
    traj = (x0[None] + rng.normal(0.0, 0.03, (64, *x0.shape))).astype(np.float32)
    return TopologyInfo.from_topology(build_topology(s)), traj


@pytest.mark.gpu
@pytest.mark.parametrize("spec,expand", [("phi_psi", True), ("rg", False),
                                         ("ca_distances", False)])
def test_compute_features_on_the_card(card, frames, spec, expand):
    info, traj = frames
    X, _ = api.compute_features(traj, spec, info, cos_sin_expand=expand, use_cache=False)
    Xt, _ = api.compute_features(torch.as_tensor(traj, device=card), spec, info,
                                 cos_sin_expand=expand, use_cache=False)
    Xc, _ = api.compute_features(traj, spec, info, cos_sin_expand=expand, use_cache=False,
                                 device="cpu")
    for out in (X, Xt):
        assert isinstance(out, np.ndarray) and out.shape == Xc.shape
        np.testing.assert_allclose(out, Xc, atol=1e-5, rtol=0)
    # the cache keys a CUDA tensor as its host copy
    hit, _ = api.compute_features(traj, spec, info, cos_sin_expand=expand)
    assert api.compute_features(torch.as_tensor(traj, device=card), spec, info,
                                cos_sin_expand=expand)[0] is hit


@pytest.mark.gpu
def test_align_trajectory_on_the_card(card, frames):
    _, traj = frames
    theta = 0.7
    R = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                  [0, 0, 1]])
    block = np.concatenate([traj[:8], (traj[3] @ R.T + [1.0, -0.5, 2.0])[None]]).astype(
        np.float32)
    out = api.align_trajectory(block)
    out_t = api.align_trajectory(torch.as_tensor(block, device=card))
    ref = api.align_trajectory(block, device="cpu")
    for o in (out, out_t):
        assert isinstance(o, np.ndarray)
        np.testing.assert_allclose(o, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[8], out[3], atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_trig_expand_periodic_on_the_card(card):
    X = np.random.default_rng(0).uniform(-np.pi, np.pi, (500, 6)).astype(np.float32)
    Z = api.trig_expand_periodic(X)
    Zt = api.trig_expand_periodic(torch.as_tensor(X, device=card))
    Zc = api.trig_expand_periodic(X, device="cpu")
    for z in (Z, Zt):
        assert isinstance(z, np.ndarray) and z.shape == (500, 12)
        np.testing.assert_allclose(z, Zc, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_universal_embedding_on_the_card(card, frames):
    info, traj = frames
    emb = api.compute_universal_embedding(traj, info)
    api.clear_feature_cache()
    ref = api.compute_universal_embedding(traj, info, device="cpu")
    assert isinstance(emb, np.ndarray) and emb.shape == ref.shape == (64, 2)
    signs = np.sign(np.sum(emb * ref, axis=0))
    np.testing.assert_allclose(emb * signs, ref, atol=1e-5 * max(1.0, np.abs(ref).max()),
                               rtol=0)
    api.clear_feature_cache()
    metric = api.compute_universal_metric(torch.as_tensor(traj, device=card), info)
    assert isinstance(metric, np.ndarray)
    np.testing.assert_allclose(np.abs(metric), np.abs(ref[:, 0]), atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_cluster_microstates_on_the_card(card):
    rng = np.random.default_rng(0)
    centers = np.array([[-2.0, -2.0], [2.0, -2.0], [-2.0, 2.0], [2.0, 2.0]])
    Y = np.concatenate([rng.normal(c, 0.2, (300, 2)) for c in centers]).astype(np.float32)
    labels = api.cluster_microstates(Y, n_states=4, random_state=1)
    ref = api.cluster_microstates(Y, n_states=4, random_state=1, device="cpu")
    assert isinstance(labels, np.ndarray) and labels.dtype == np.int64
    assert len(set(zip(labels.tolist(), ref.tolist()))) == 4 == len(set(labels.tolist()))
