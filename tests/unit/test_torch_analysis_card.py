"""The analysis half's device code on the card, against its own CPU run
(this file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_analysis_card.py``).

- the log-space gamma and Dirichlet draws on ``cuda`` from an explicit
  generator: the Dirichlet mean within 4 standard errors, tiny
  concentrations finite, one seed giving one stream, the global stream
  untouched;
- the reversible Gibbs sampler on ``cuda`` against the CPU, statistically;
- ``compute_kde_fes`` on ``cuda`` against the CPU at 1e-5 of the density's
  maximum;
- ``_streaming_moments`` on ``cuda`` with TF32 off, at 1e-6 relative to a
  float64 numpy sum of the same float32 inputs.
"""

import numpy as np
import pytest
import torch

import pmarlo_tpu_torch  # noqa: F401  (pins float32 matmuls)
from pmarlo_tpu_torch.analysis import fes
from pmarlo_tpu_torch.msm import its, reduction, reversible_sampler as rs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the draws and products run on it")
    return torch.device("cuda")


@pytest.mark.gpu
def test_dirichlet_draws_on_the_card(card):
    C = np.array([[40.0, 5.0, 0.0, 1.0],
                  [3.0, 20.0, 7.0, 0.0],
                  [0.0, 2.0, 30.0, 9.0],
                  [4.0, 0.0, 6.0, 12.0]])
    alpha = C + 1e-4
    state = torch.cuda.get_rng_state()
    g = torch.Generator(device=card).manual_seed(0)
    rows = its.dirichlet_rows(torch.as_tensor(alpha, dtype=torch.float32, device=card),
                              2000, g)
    assert rows.is_cuda
    T = rows.cpu().numpy().astype(np.float64)
    a0 = alpha.sum(1, keepdims=True)
    se = np.sqrt(alpha * (a0 - alpha) / (a0**2 * (a0 + 1)) / 2000)
    assert np.isfinite(T).all()
    np.testing.assert_allclose(T.sum(-1), 1.0, atol=1e-5)
    assert (np.abs(T.mean(0) - alpha / a0) <= 4 * se + 1e-7).all()
    tiny = its.dirichlet_rows(torch.full((3, 5), 1e-4, device=card), 50,
                              torch.Generator(device=card).manual_seed(1))
    assert bool(torch.isfinite(tiny).all())
    assert bool((tiny.max(-1).values > 0.99).all())
    a = its.sample_posterior_timescales(C, 1, n_samples=16, seed=5, device=card)
    b = its.sample_posterior_timescales(C, 1, n_samples=16,
                                        generator=torch.Generator(device=card).manual_seed(5))
    np.testing.assert_array_equal(a, b)
    assert torch.equal(state, torch.cuda.get_rng_state())


@pytest.mark.gpu
def test_reversible_sampler_on_the_card_matches_the_cpu_statistically(card):
    rng = np.random.default_rng(3)
    C = rng.integers(1, 60, (7, 7)).astype(float) + 30.0 * np.eye(7)
    dev = rs.sample_reversible_timescales(C, 1, n_samples=200, n_timescales=2, seed=1,
                                          device=card)
    host = rs.sample_reversible_timescales(C, 1, n_samples=200, n_timescales=2, seed=1,
                                           device="cpu")
    assert np.isfinite(dev).all()
    for k in range(2):
        lo, hi = np.quantile(host[:, k], [0.025, 0.975])
        assert lo <= np.median(dev[:, k]) <= hi
        lo, hi = np.quantile(dev[:, k], [0.025, 0.975])
        assert lo <= np.median(host[:, k]) <= hi
    X = rs.sample_reversible_posterior(C, 16, seed=2, return_flow=True, device=card)
    for x in X:
        assert np.abs(x - x.T).max() <= 1e-6 * np.abs(x).max()


@pytest.mark.gpu
def test_kde_fes_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(0)
    x, y = rng.normal(0, 1.0, 20_000), rng.normal(0, 0.5, 20_000)
    w = rng.uniform(0.5, 2.0, 20_000)
    for kw in (dict(bins=64), dict(bins=(48, 40), weights=w, bandwidth="silverman")):
        dev = fes.compute_kde_fes(x, y, device=card, **kw)
        host = fes.compute_kde_fes(x, y, device="cpu", **kw)
        assert np.abs(dev.counts - host.counts).max() <= 1e-5 * host.counts.max()
        np.testing.assert_array_equal(dev.xedges, host.xedges)


@pytest.mark.gpu
def test_streaming_moments_on_the_card_without_tf32(card):
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(4)
    # a running mean over 10 frames: lag-5 products of order the variance
    box = np.ones(10) / np.sqrt(10.0)
    seqs = [np.stack([np.convolve(c, box, mode="valid") for c in rng.normal(size=(8, n))],
                     1).astype(np.float32) for n in (20_000, 7_000)]
    C00, C0t, Ctt, n = reduction._streaming_moments(seqs, 5, device=card)
    X0 = np.concatenate([s[:-5] for s in seqs]).astype(np.float64)
    Xt = np.concatenate([s[5:] for s in seqs]).astype(np.float64)
    assert n == X0.shape[0]
    m0, mt = X0.mean(0), Xt.mean(0)
    for got, want in ((C00, X0.T @ X0 / n - np.outer(m0, m0)),
                      (C0t, X0.T @ Xt / n - np.outer(m0, mt)),
                      (Ctt, Xt.T @ Xt / n - np.outer(mt, mt))):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
