"""The least time the card could take for the work of a fused MD launch.

A frozen copy of ``chip_smoke.py``'s ``_bound`` / ``_md_bound`` and their
constants (``HBM_BYTES_PER_S``, ``FP32_FLOPS``, ``SFU_OPS_PER_S``,
``NEWTON_OPS``) at commit be358b3, kept here as the benchmark's yardstick.
They count the least work of the function whatever the design: each
unordered pair of a force evaluation once, the CV bias's dihedrals, MLP
and hills where a run has them, state and the (N, N) tables in and out
once, the frames out once.
"""

from __future__ import annotations

# One H100 SXM (NVIDIA's data sheet): HBM bandwidth and the float32 rate
# outside the tensor cores; the special-function rate: 132 SMs x 16 SFU
# results a clock at the 1,980 MHz boost clock (Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# float32 operations and special-function results of each unordered pair in
# the three GB sweeps of a force evaluation: Born radii (I_i and I_j), the
# pair energy with dE/dB both sides, the forces with both Born chain terms
NEWTON_OPS = {"born": (67, 2), "energy": (52, 3), "force": (143, 10)}


def bound(flops: float, sfu: float, n_bytes: float) -> dict:
    """Least milliseconds: the larger of the bytes over the memory rate and
    the operations over their peak rates."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(flops / FP32_FLOPS, sfu / SFU_OPS_PER_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def md_bound(R: int, N: int, n_force_evals: int, *, n_dih: int = 0, widths=(),
             n_hills: int = 0, frames: int = 0) -> dict:
    """``n_force_evals`` force evaluations of R replicas of N atoms, plus the
    CV bias (M dihedrals computed once and once more per role, the MLP
    forward and backward, the hills sum), state in and out once, the (N, N)
    tables once, ``frames`` frames out."""
    pairs = N * (N - 1) / 2
    flops = pairs * sum(f for f, _ in NEWTON_OPS.values())
    sfu = pairs * sum(t for _, t in NEWTON_OPS.values())
    if n_dih:
        mlp = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        flops += 5 * n_dih * 150 + 4 * mlp + n_hills * 20
        sfu += 5 * n_dih * 4 + sum(widths[1:-1]) + n_hills
    n_bytes = 4 * (4 * R * N * 3 + R + 6 * N * N + 9 * N
                   + frames * R * (N * 3 + 2) + 3 * n_hills)
    return bound(R * n_force_evals * flops, R * n_force_evals * sfu, n_bytes)
