"""Triclinic periodic-cell utilities.

Port of ``pmarlo_tpu/md/box.py``. The lattice algebra on the host
(``box_matrix`` ... ``volume``, ``tilt_ratios``, ``dodecahedron_vectors``)
is numpy and is carried as it is, function by function
(``tests/unit/test_torch_host_copies.py`` holds each equal to its source);
``latmul``, ``wrap_frac``, ``min_image_round``, ``min_image_exact``,
``traced_matrices`` and ``traced_perp_widths`` are tensor functions.

Conventions (GROMACS reduced form; rows are lattice vectors, positions
are row vectors so ``x = f @ H``):

    H = [[ax, 0,  0 ],
         [bx, by, 0 ],
         [cx, cy, cz]]      with ax, by, cz > 0,
    |bx| <= ax/2,  |cx| <= ax/2,  |cy| <= by/2.

The triclinic ``tilt`` is the off-diagonal triple ``(bx, cx, cy)``;
``System.box`` carries the diagonal ``(ax, by, cz)`` and ``System.tilt`` is
``None`` for orthorhombic cells.

Correctness bound: with slab perpendicular widths >= cutoff per cell
layer, the fractional coordinate along axis k is the normal-projected
coordinate scaled by the perpendicular width, so two atoms within the
cutoff always land in adjacent (or the same) cells: the 27-neighbourhood
cover argument carries over from the orthorhombic case.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

Tilt = Tuple[float, float, float]


def box_matrix(
    box: Sequence[float], tilt: Optional[Sequence[float]] = None
) -> np.ndarray:
    """(3, 3) lattice matrix H (rows = a, b, c) from diagonal lengths
    ``box`` = (ax, by, cz) and off-diagonal ``tilt`` = (bx, cx, cy)."""
    ax, by, cz = (float(v) for v in box)
    bx, cx, cy = (0.0, 0.0, 0.0) if tilt is None else (
        float(v) for v in tilt
    )
    return np.array(
        [[ax, 0.0, 0.0], [bx, by, 0.0], [cx, cy, cz]], dtype=np.float64
    )


def reduce_box_matrix(H: np.ndarray) -> np.ndarray:
    """Lattice reduction to the GROMACS form (|bx| <= ax/2 etc.).

    Adding integer multiples of one lattice vector to another describes
    the SAME lattice; positions re-image correctly through wrapping."""
    H = np.array(H, dtype=np.float64)

    def rt(v: float) -> float:
        # tolerant round: the |t| == half-diagonal boundary (the
        # rhombic dodecahedron sits exactly there) canonicalizes to the
        # POSITIVE representation regardless of float roundoff —
        # +0.5(+eps) stays, -0.5(-eps) flips to +0.5
        return np.floor(v + 0.5 - 1e-9)

    # order matters: reduce c against b first (changes cx too), then
    # c and b against a
    H[2] -= H[1] * rt(H[2, 1] / H[1, 1])
    H[2] -= H[0] * rt(H[2, 0] / H[0, 0])
    H[1] -= H[0] * rt(H[1, 0] / H[0, 0])
    return H


def split_matrix(H: np.ndarray) -> Tuple[Tuple[float, float, float],
                                         Optional[Tilt]]:
    """(box diagonal, tilt-or-None) from a lower-triangular H."""
    H = np.asarray(H, dtype=np.float64)
    if (abs(H[0, 1]) > 1e-12 or abs(H[0, 2]) > 1e-12
            or abs(H[1, 2]) > 1e-12):
        raise ValueError(
            "box matrix must be lower-triangular (rows a, b, c with "
            "a along x and b in the xy plane); rotate the cell first"
        )
    box = (float(H[0, 0]), float(H[1, 1]), float(H[2, 2]))
    tilt = (float(H[1, 0]), float(H[2, 0]), float(H[2, 1]))
    if max(abs(t) for t in tilt) < 1e-9:
        return box, None
    return box, tilt


def from_lengths_angles(
    a: float, b: float, c: float,
    alpha: float, beta: float, gamma: float,
) -> Tuple[Tuple[float, float, float], Optional[Tilt]]:
    """CRYST1 cell (lengths nm, angles degrees) -> (box, tilt) in
    reduced form. Standard crystallographic construction: a along x,
    b in the xy plane."""
    al, be, ga = (np.deg2rad(v) for v in (alpha, beta, gamma))
    bx = b * np.cos(ga)
    by = b * np.sin(ga)
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz2 = c * c - cx * cx - cy * cy
    # 'not (> 0)' rather than '<= 0': gamma == 0 makes cy = 0/0 = NaN,
    # and NaN <= 0 is False — the degenerate cell must still raise
    if not (cz2 > 0.0):
        raise ValueError(
            f"degenerate cell: lengths ({a}, {b}, {c}) nm with angles "
            f"({alpha}, {beta}, {gamma}) deg have no positive volume"
        )
    H = reduce_box_matrix(
        np.array([[a, 0.0, 0.0], [bx, by, 0.0], [cx, cy, np.sqrt(cz2)]])
    )
    box, tilt = split_matrix(H)
    # snap angle roundoff (90.00 deg stored in 2 decimals) to exactly
    # orthorhombic when the tilt is within PDB-format precision
    if tilt is not None and max(abs(t) for t in tilt) < 5e-4 * max(a, b, c):
        return box, None
    return box, tilt


def to_lengths_angles(
    box: Sequence[float], tilt: Optional[Sequence[float]] = None
) -> Tuple[float, float, float, float, float, float]:
    """(a, b, c, alpha, beta, gamma) — lengths nm, angles degrees."""
    H = box_matrix(box, tilt)
    la, lb, lc = (float(np.linalg.norm(H[i])) for i in range(3))
    cosa = float(np.dot(H[1], H[2]) / (lb * lc))
    cosb = float(np.dot(H[0], H[2]) / (la * lc))
    cosg = float(np.dot(H[0], H[1]) / (la * lb))
    return (la, lb, lc, *(float(np.rad2deg(np.arccos(v)))
                          for v in (cosa, cosb, cosg)))


def validate_reduced(H: np.ndarray) -> None:
    """Raise unless H is in reduced form with positive diagonal."""
    H = np.asarray(H, dtype=np.float64)
    if not (H[0, 0] > 0 and H[1, 1] > 0 and H[2, 2] > 0):
        raise ValueError(f"box diagonal must be positive, got {np.diag(H)}")
    # strict inequality with a tiny slack: exactly ax/2 is legal
    eps = 1e-7 * max(H[0, 0], H[1, 1], H[2, 2])
    if (abs(H[1, 0]) > 0.5 * H[0, 0] + eps
            or abs(H[2, 0]) > 0.5 * H[0, 0] + eps
            or abs(H[2, 1]) > 0.5 * H[1, 1] + eps):
        raise ValueError(
            f"box tilt {H[1, 0], H[2, 0], H[2, 1]} exceeds the reduced "
            f"bound (ax/2, ax/2, by/2) = "
            f"{0.5 * H[0, 0], 0.5 * H[0, 0], 0.5 * H[1, 1]}; call "
            "reduce_box_matrix first"
        )


def perp_widths(H: np.ndarray) -> np.ndarray:
    """(3,) perpendicular distances between opposite cell faces: the
    quantity the cutoff/cell-cover conditions bound (for orthorhombic
    cells these ARE the box lengths).  d_k = V / |a_i x a_j|."""
    H = np.asarray(H, dtype=np.float64)
    V = abs(float(np.linalg.det(H)))
    return np.array([
        V / np.linalg.norm(np.cross(H[1], H[2])),
        V / np.linalg.norm(np.cross(H[2], H[0])),
        V / np.linalg.norm(np.cross(H[0], H[1])),
    ])


def volume(box: Sequence[float],
           tilt: Optional[Sequence[float]] = None) -> float:
    """Cell volume (nm^3). Lower-triangular H: product of the diagonal
    (the tilt never changes the volume)."""
    return float(np.prod([float(v) for v in box]))


def latmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lattice-transform product in full float32: a ~0.01 nm error in a
    fractional coordinate flips floor/round near cell boundaries, so these
    (N, 3) @ (3, 3) products never run in TF32 (``_precision.py`` pins
    float32 matmuls at highest precision; this one is written as explicit
    multiply-adds so that no setting can lower it)."""
    return (a[..., :, None] * b).sum(-2)


def wrap_frac(x: torch.Tensor, H: torch.Tensor, Hinv: torch.Tensor) -> torch.Tensor:
    """Wrap positions into the primary cell via fractional coordinates."""
    f = latmul(x, Hinv)
    f = f - torch.floor(f)
    return latmul(f, H)


def min_image_round(d: torch.Tensor, H: torch.Tensor, Hinv: torch.Tensor) -> torch.Tensor:
    """Nearest-image displacement by component rounding in fractional
    space (round half to even, as ``jnp.round``). Exact whenever the true
    minimal distance is below half the smallest perpendicular width; for
    orthorhombic H this is ``d - box * round(d / box)``."""
    return d - latmul(torch.round(latmul(d, Hinv)), H)


def min_image_exact(d: torch.Tensor, H) -> torch.Tensor:
    """True minimum-image displacement by brute force over the 27
    neighbour images of the rounded one (an oracle for tests)."""
    H64 = np.asarray(H.detach().cpu().numpy() if isinstance(H, torch.Tensor) else H,
                     np.float64)
    Hj = torch.as_tensor(H64, dtype=d.dtype, device=d.device)
    Hinv = torch.as_tensor(np.linalg.inv(H64), dtype=d.dtype, device=d.device)
    base = min_image_round(d, Hj, Hinv)
    grid = np.array(np.meshgrid(*([[-1.0, 0.0, 1.0]] * 3), indexing="ij")).reshape(3, -1).T
    shifts = latmul(torch.as_tensor(grid, dtype=d.dtype, device=d.device), Hj)  # (27, 3)
    cand = base[..., None, :] + shifts                                         # (..., 27, 3)
    pick = (cand * cand).sum(-1).argmin(-1)
    return torch.take_along_dim(cand, pick[..., None, None], dim=-2)[..., 0, :]


def tilt_ratios(box: Sequence[float],
                tilt: Sequence[float]) -> Tuple[float, float, float]:
    """Static (bx/ax, cx/ax, cy/by). The Monte-Carlo barostat's volume
    moves scale the whole lattice isotropically, so these ratios are
    INVARIANT along an NPT trajectory: a traced (3,) diagonal plus the
    static ratios fully determines the evolving triclinic cell — the
    barostat itself never needs to know about tilt."""
    ax, by, _ = (float(v) for v in box)
    bx, cx, cy = (float(v) for v in tilt)
    return (bx / ax, cx / ax, cy / by)


def traced_matrices(box: torch.Tensor,
                    ratios: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, Hinv) as (3, 3) tensors from a (3,) diagonal tensor and static
    tilt ratios (closed-form lower-triangular inverse)."""
    a, b, c = box[0], box[1], box[2]
    rbx, rcx, rcy = (float(r) for r in ratios)
    p, q, r = rbx * a, rcx * a, rcy * b
    z = torch.zeros_like(a)
    H = torch.stack([
        torch.stack([a, z, z]),
        torch.stack([p, b, z]),
        torch.stack([q, r, c]),
    ])
    Hinv = torch.stack([
        torch.stack([1.0 / a, z, z]),
        torch.stack([-p / (a * b), 1.0 / b, z]),
        torch.stack([(p * r - q * b) / (a * b * c), -r / (b * c), 1.0 / c]),
    ])
    return H, Hinv


def traced_perp_widths(box: torch.Tensor, ratios: Sequence[float]) -> torch.Tensor:
    """(3,) perpendicular widths from a diagonal tensor + static ratios."""
    H, _ = traced_matrices(box, ratios)
    V = box[0] * box[1] * box[2]
    cross = torch.stack([
        torch.linalg.cross(H[1], H[2]),
        torch.linalg.cross(H[2], H[0]),
        torch.linalg.cross(H[0], H[1]),
    ])
    return V / torch.sqrt((cross * cross).sum(1))


def dodecahedron_vectors(d: float) -> Tuple[Tuple[float, float, float],
                                            Tilt]:
    """Rhombic-dodecahedron cell with image distance ``d`` (nm) in
    reduced triclinic form (the GROMACS ``-bt dodecahedron`` cell,
    xy-square variant): volume 0.707 d^3 vs the cube's d^3 — ~29% less
    solvent for the same solute clearance."""
    d = float(d)
    return ((d, d, d * np.sqrt(2.0) / 2.0),
            (0.0, d / 2.0, d / 2.0))


__all__ = [
    "Tilt", "box_matrix", "reduce_box_matrix", "split_matrix",
    "from_lengths_angles", "to_lengths_angles", "validate_reduced",
    "perp_widths", "volume", "tilt_ratios", "dodecahedron_vectors", "latmul",
    "wrap_frac", "min_image_round", "min_image_exact", "traced_matrices",
    "traced_perp_widths",
]
