"""Reversible Bayesian transition-matrix posterior (Gibbs sampler).

Port of ``pmarlo_tpu/msm/reversible_sampler.py``. It samples the posterior
of deeptime's ``BayesianMSM`` reversible sampler used by the reference
(reference: src/pmarlo/markov_state_model/_its.py:289-312):
p(T | C) ∝ Π_ij T_ij^{C_ij} restricted to detailed-balance transition
matrices, by element-wise Gibbs sweeps over the symmetric flow matrix X
(x_ij = pi_i T_ij), following Trendelkamp-Schroer et al., J. Chem. Phys.
143, 174101 (2015).

One sweep is split by a round-robin edge colouring of the complete graph
(the circle method): the n(n-1)/2 off-diagonal conditionals fall into
(m-1) rounds of m/2 vertex-disjoint edges, each round one vectorised
Metropolis update; the n diagonal conditionals are independent, one
vectorised exact Beta draw. The chains are a leading batch dimension of
every tensor, and the sweeps and rounds a Python loop of float32 tensor
operations on the generator's device (float32 as in JAX, whose ``1e-300``
clamps round to 0 there and here alike). Every draw comes from an explicit
``torch.Generator``; the Beta is built from two log-gammas.

Exact conditionals (flat prior on x > 0):
  diagonal:      s = x_ii/(x_ii+b) ~ Beta(C_ii + 1, C_i - C_ii - 1),
                 b = Σ_{k≠i} x_ik held fixed.
  off-diagonal:  p(x) ∝ x^{C_ij+C_ji} (b_i+x)^{-C_i} (b_j+x)^{-C_j};
                 non-standard — one log-normal random-walk Metropolis step
                 per sweep (same treatment as deeptime/msmtools).
Edges with C_ij + C_ji = 0 are held at x = 0 exactly (deeptime's sparsity
structure). Eigenvalues come from the detailed-balance symmetrization
S = X / sqrt(x_i x_j) (real spectrum, ``eigvalsh`` on the host).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.errors import EstimationError
from ..utils.msm_utils import ensure_connected_counts
from .its import _generator, log_gamma


def _round_robin_schedule(n: int) -> Tuple[np.ndarray, int]:
    """Edge coloring of K_n via the circle method.

    Returns ``(pairs, m)``: ``pairs`` has shape (m-1, m//2, 2) where m is n
    rounded up to even; every unordered pair (i, j), i<j<m appears exactly
    once, and within a round all pairs are vertex-disjoint (so their Gibbs
    updates are conditionally independent). Pairs touching the padding
    vertex (index >= n) must be masked by the caller.
    """
    m = n if n % 2 == 0 else n + 1
    rounds = []
    for r in range(m - 1):
        row = [(m - 1, r)]
        for k in range(1, m // 2):
            row.append(((r + k) % (m - 1), (r - k) % (m - 1)))
        rounds.append(row)
    pairs = np.asarray(rounds, dtype=np.int32)  # (m-1, m//2, 2)
    # canonical i<j ordering (irrelevant to correctness, nice for debugging)
    lo = pairs.min(axis=-1)
    hi = pairs.max(axis=-1)
    return np.stack([lo, hi], axis=-1), m


def _init_flow_matrix(C: np.ndarray) -> np.ndarray:
    """Reversible-MLE flow matrix as the chain start (mode of the posterior)."""
    from .estimation import reversible_mle, stationary_distribution

    T = reversible_mle(C)
    pi = stationary_distribution(T)
    X = pi[:, None] * T
    X = 0.5 * (X + X.T)  # exact symmetry
    return X / max(X.sum(), 1e-300)


def _beta(a: torch.Tensor, b: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Beta(a, b) elementwise, as G_a / (G_a + G_b) from log-gammas."""
    return torch.sigmoid(log_gamma(a, generator) - log_gamma(b, generator))


def _run_chains(
    X0: torch.Tensor,           # (m, m) symmetric start (shared by chains)
    C: torch.Tensor,            # (m, m) counts (padded)
    pairs: torch.Tensor,        # (n_rounds, m//2, 2)
    edge_valid: torch.Tensor,   # (n_rounds, m//2) bool
    edge_sigma: torch.Tensor,   # (n_rounds, m//2) proposal widths
    diag_valid: torch.Tensor,   # (m,) bool
    generator: torch.Generator,
    *,
    n_chains: int,
    n_burn: int,
    n_keep: int,
    n_thin: int,
) -> torch.Tensor:
    """All chains' kept samples, shape (n_chains, n_keep, m, m) flow matrices."""
    m = X0.shape[0]
    Ci = C.sum(1)                               # row counts (m,)
    Cd = torch.diagonal(C)
    Csym = C + C.T
    idx = torch.arange(m, device=X0.device)
    a1 = Cd + 1.0
    a2 = torch.clamp(Ci - Cd - 1.0, min=1e-2)
    # each round's edges and their constants, gathered once
    I, J = pairs[..., 0].long(), pairs[..., 1].long()
    CS, CI, CJ = Csym[I, J], Ci[I], Ci[J]
    rounds = [(I[r], J[r], edge_valid[r], edge_sigma[r], CS[r], CI[r], CJ[r])
              for r in range(pairs.shape[0])]
    shape = (n_chains, m // 2)

    def sweep(X, xrow):
        # --- all-diagonal exact Beta step (mutually independent) ---
        d = torch.diagonal(X, dim1=1, dim2=2)
        b = torch.clamp(xrow - d, min=1e-300)
        s = torch.clamp(_beta(a1.expand(n_chains, m), a2.expand(n_chains, m), generator),
                        1e-12, 1.0 - 1e-7)
        new_d = torch.where(diag_valid, b * s / (1.0 - s), d)
        X[:, idx, idx] = new_d
        xrow = torch.where(diag_valid, b + new_d, xrow)

        # --- edge rounds: vertex-disjoint Metropolis updates ---
        for i, j, valid, sig, cs, ci, cj in rounds:
            x = X[:, i, j]
            x_safe = torch.where(valid, x, 1.0)
            bi = torch.clamp(xrow[:, i] - x, min=1e-300)
            bj = torch.clamp(xrow[:, j] - x, min=1e-300)
            z = torch.randn(shape, generator=generator, dtype=X.dtype, device=X.device)
            xp = x_safe * torch.exp(sig * z)

            def logpost(xx):
                return (cs * torch.log(xx) - ci * torch.log(bi + xx)
                        - cj * torch.log(bj + xx))

            # + log-Jacobian of the log-scale random walk
            loga = (logpost(xp) - logpost(x_safe)
                    + torch.log(xp) - torch.log(x_safe))
            u = torch.rand(shape, generator=generator, dtype=X.dtype, device=X.device)
            accept = valid & (torch.log(u) < loga)
            xn = torch.where(accept, xp, x)
            X[:, i, j] = xn
            X[:, j, i] = xn
            delta = xn - x
            # i and j are disjoint sets of distinct vertices in a round
            xrow[:, i] += delta
            xrow[:, j] += delta
        # renormalize (posterior is scale-invariant; keeps numerics bounded)
        total = torch.clamp(xrow.sum(1), min=1e-300)
        return X / total[:, None, None], xrow / total[:, None]

    X = X0.expand(n_chains, m, m).clone()
    xrow = X.sum(2)
    for _ in range(n_burn):
        X, xrow = sweep(X, xrow)
    kept = []
    for _ in range(n_keep):
        for _ in range(n_thin):
            X, xrow = sweep(X, xrow)
        kept.append(X.clone())  # the next sweep writes into X
    return torch.stack(kept, dim=1)


def sample_reversible_posterior(
    counts: np.ndarray,
    n_samples: int = 100,
    *,
    prior: float = 0.0,
    n_burn: int = 50,
    n_thin: int = 2,
    n_chains: int = 8,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    return_flow: bool = False,
    device=None,
) -> np.ndarray:
    """Sample reversible transition matrices from p(T | C).

    Returns (n_samples, n, n) stochastic matrices satisfying detailed
    balance (each sample's stationary flow matrix is exactly symmetric).
    ``counts`` must be connected (use ``ensure_connected_counts`` first);
    ``prior`` adds a pseudocount to every observed (C+C.T > 0) element.
    The chains run on ``generator``'s device, or with a new generator
    seeded with ``seed`` on ``device`` (``None``: the default device).
    """
    C = np.asarray(counts, dtype=np.float64)
    n = C.shape[0]
    if n < 2:
        raise EstimationError("reversible sampler needs >= 2 states")
    if prior:
        C = C + prior * ((C + C.T) > 0)
    X0 = _init_flow_matrix(C)

    pairs_np, m = _round_robin_schedule(n)
    if m > n:  # pad with an inert vertex
        Cp = np.zeros((m, m))
        Cp[:n, :n] = C
        Xp = np.zeros((m, m))
        Xp[:n, :n] = X0
        C, X0 = Cp, Xp
    csym = C + C.T
    i, j = pairs_np[..., 0], pairs_np[..., 1]
    edge_valid = (j < n) & (csym[i, j] > 0)
    # proposal width ~ posterior std of log x (1/sqrt of the information)
    edge_sigma = 2.4 / np.sqrt(1.0 + csym[i, j])
    diag_valid = np.arange(m) < n

    n_keep = -(-n_samples // n_chains)  # ceil
    generator = _generator(generator, seed, device)
    dev = generator.device

    def on_device(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    Xs = _run_chains(
        on_device(X0), on_device(C), on_device(pairs_np, torch.int64),
        on_device(edge_valid, torch.bool), on_device(edge_sigma),
        on_device(diag_valid, torch.bool), generator,
        n_chains=n_chains, n_burn=n_burn, n_keep=n_keep, n_thin=n_thin,
    )
    X = Xs.cpu().numpy().astype(np.float64).reshape(-1, m, m)[:n_samples, :n, :n]
    if return_flow:
        return X
    xrow = X.sum(axis=2, keepdims=True)
    return X / np.maximum(xrow, 1e-300)


def sample_reversible_timescales(
    counts: np.ndarray,
    lag: int,
    *,
    n_samples: int = 100,
    n_timescales: int = 5,
    dt: float = 1.0,
    prior: float = 0.0,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """(n_samples, k) implied timescales from the reversible posterior.

    Drop-in for :func:`pmarlo_tpu_torch.msm.its.sample_posterior_timescales`
    with reference-matching (reversible) posterior semantics. Eigenvalues
    use the detailed-balance symmetrization S_ij = x_ij / sqrt(x_i x_j) —
    real spectrum by construction, solved with batched ``eigvalsh``.
    """
    from .its import _timescales_from_eigvals

    C, _active = ensure_connected_counts(np.asarray(counts), alpha=0.0)
    n = C.shape[0]
    if n < 2:
        return np.full((n_samples, n_timescales), np.nan)
    X = sample_reversible_posterior(
        C, n_samples, prior=prior, generator=generator, seed=seed,
        return_flow=True, device=device,
    )
    xrow = X.sum(axis=2)
    denom = np.sqrt(np.maximum(xrow[:, :, None] * xrow[:, None, :], 1e-300))
    S = X / denom
    evals = np.linalg.eigvalsh(S)
    return _timescales_from_eigvals(evals, lag, dt, n_timescales)


__all__ = [
    "sample_reversible_posterior",
    "sample_reversible_timescales",
]
