"""Port parity for the MSM stack: Lloyd k-means, transition counting and
``discretize_dataset`` against the JAX package on the same inputs."""

import jax
import numpy as np
import pytest
import torch

from pmarlo_tpu.analysis.discretize import discretize_dataset as jax_discretize
from pmarlo_tpu.msm import clustering as jax_clustering
from pmarlo_tpu.msm.counting import counts_from_dtrajs as jax_counts
from pmarlo_tpu_torch.analysis.discretize import discretize_dataset
from pmarlo_tpu_torch.msm import clustering
from pmarlo_tpu_torch.msm.counting import count_transitions, counts_from_dtrajs


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _blob_shards(n_shards, per, centers, sigma, seed):
    """bench_msm-style shards: features drawn around ``centers``."""
    rng = np.random.default_rng(seed)
    centers = np.asarray(centers, np.float64)
    shards = []
    for _ in range(n_shards):
        which = rng.integers(0, len(centers), per)
        X = (centers[which] + rng.normal(0.0, sigma, (per, centers.shape[1])))
        shards.append({"features": X.astype(np.float32), "metadata": {"stride": 1}})
    return shards


def test_lloyd_matches_jax_from_the_same_centers():
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 1.0, (400, 4)).astype(np.float32)
    init = x[:7].copy()
    jc, jl, ji = jax_clustering._lloyd(jax.numpy.asarray(x), jax.numpy.asarray(init), 10)
    tc, tl, ti = clustering._lloyd(torch.from_numpy(x), torch.from_numpy(init), 10)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # centers are float32 means of the same members, summed in another order
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    assert abs(float(ti) - float(ji)) <= 1e-5 * float(ji)


def test_assign_to_centers_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 1.0, (300, 4)).astype(np.float32)
    c = rng.normal(0.0, 1.0, (9, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        clustering.assign_to_centers(x, c), jax_clustering.assign_to_centers(x, c))


def test_kmeans_pp_init_picks_distinct_data_points():
    x = torch.as_tensor(np.random.default_rng(2).normal(0, 1, (200, 3)), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    c = clustering._kmeans_pp_init(g, x, 5)
    assert bool((c[:, None, :] == x[None, :, :]).all(-1).any(1).all())
    assert len({tuple(row) for row in c.numpy().round(6)}) == 5


def test_counts_match_jax():
    rng = np.random.default_rng(3)
    dtrajs = [rng.integers(-1, 6, n) for n in (50, 3, 120, 77)]
    for lag in (1, 3):
        for mode in ("sliding", "strided"):
            np.testing.assert_array_equal(
                counts_from_dtrajs(dtrajs, lag, 6, count_mode=mode),
                jax_counts(dtrajs, lag, 6, count_mode=mode))
    counts, n = count_transitions(dtrajs, 2)
    assert n == 6 and counts.dtype == np.float64


def test_discretize_grid_matches_jax():
    """The deterministic grid route through both stacks: identical dtrajs
    and counts, transition matrices to 1e-6."""
    shards = _blob_shards(5, 200, [[-1.0] * 4, [1.0] * 4], 0.3, seed=4)
    j = jax_discretize(shards, n_states=16, lag=10, method="grid")
    t = discretize_dataset(shards, n_states=16, lag=10, method="grid")
    for a, b in zip(j.dtrajs, t.dtrajs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j.counts, t.counts)
    np.testing.assert_allclose(t.transition_matrix, j.transition_matrix, atol=1e-6)


def test_discretize_kmeans_matches_jax_up_to_relabeling():
    """k-means++ draws from a torch Generator in the port and from a JAX key
    in the reference, so state numbers differ. On four well-separated blobs
    both find the same partition: after relabeling by matched centers the
    dtrajs are identical and the transition matrices agree to 1e-6."""
    centers = [[3, 0, 0, 0], [0, 3, 0, 0], [0, 0, 3, 0], [0, 0, 0, 3]]
    shards = _blob_shards(6, 150, centers, 0.1, seed=5)
    j = jax_discretize(shards, n_states=4, lag=1, seed=0)
    t = discretize_dataset(shards, n_states=4, lag=1, seed=0)
    # perm[k] = the JAX state of port state k
    d = ((t.centers[:, None, :] - j.centers[None, :, :]) ** 2).sum(-1)
    perm = d.argmin(1)
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
    np.testing.assert_allclose(t.centers, j.centers[perm], atol=1e-5)
    for a, b in zip(j.dtrajs, t.dtrajs):
        np.testing.assert_array_equal(a, perm[b])
    np.testing.assert_allclose(
        t.transition_matrix, j.transition_matrix[np.ix_(perm, perm)], atol=1e-6)
