"""``pmarlo_tpu_torch/md/box.py`` against ``pmarlo_tpu/md/box.py``.

The numpy lattice functions are the source's own text (held by
``test_torch_host_copies.py``); here every function of the module, numpy
and tensor, is run beside its JAX counterpart on the same numpy-seeded
inputs, for an orthorhombic and a triclinic cell. Tolerances: numpy
functions exact (the same float64 arithmetic); tensor functions 2e-6 nm
(float32 products summed in another order than XLA's matmul).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmarlo_tpu.md import box as jbox
from pmarlo_tpu_torch.md import box as tbox

CELLS = {
    "orthorhombic": ((3.0, 2.8, 2.6), None),
    "triclinic": ((3.0, 2.8, 2.6), (0.4, -0.7, 0.9)),
    "dodecahedron": tbox.dodecahedron_vectors(3.2),
}
ATOL = 2e-6


@pytest.fixture(params=sorted(CELLS))
def cell(request):
    box, tilt = CELLS[request.param]
    return box, tilt, tbox.box_matrix(box, tilt)


def _points(seed, n=200, scale=6.0):
    return np.random.default_rng(seed).uniform(-scale, scale, (n, 3)).astype(np.float32)


def test_numpy_lattice_functions_equal(cell):
    box, tilt, H = cell
    assert np.array_equal(H, jbox.box_matrix(box, tilt))
    assert np.array_equal(tbox.perp_widths(H), jbox.perp_widths(H))
    assert tbox.volume(box, tilt) == jbox.volume(box, tilt)
    assert tbox.to_lengths_angles(box, tilt) == jbox.to_lengths_angles(box, tilt)
    assert tbox.split_matrix(H) == jbox.split_matrix(H)
    tbox.validate_reduced(H)
    jbox.validate_reduced(H)
    if tilt is not None:
        assert tbox.tilt_ratios(box, tilt) == jbox.tilt_ratios(box, tilt)


def test_reduction_and_cryst1_round_trip(cell):
    box, tilt, H = cell
    wild = H.copy()
    wild[2] += 2.0 * wild[1] - 3.0 * wild[0]
    wild[1] += 1.0 * wild[0]
    red = tbox.reduce_box_matrix(wild)
    assert np.array_equal(red, jbox.reduce_box_matrix(wild))
    tbox.validate_reduced(red)
    a, b, c, al, be, ga = tbox.to_lengths_angles(box, tilt)
    assert tbox.from_lengths_angles(a, b, c, al, be, ga) == \
        jbox.from_lengths_angles(a, b, c, al, be, ga)
    box2, tilt2 = tbox.from_lengths_angles(a, b, c, al, be, ga)
    np.testing.assert_allclose(tbox.box_matrix(box2, tilt2), H, atol=1e-9)


def test_rejections_match():
    for fn in (tbox, jbox):
        with pytest.raises(ValueError, match="lower-triangular"):
            fn.split_matrix(np.array([[1.0, 0.1, 0], [0, 1, 0], [0, 0, 1]]))
        with pytest.raises(ValueError, match="reduced"):
            fn.validate_reduced(fn.box_matrix((2.0, 2.0, 2.0), (1.5, 0.0, 0.0)))
        with pytest.raises(ValueError, match="degenerate"):
            fn.from_lengths_angles(1.0, 1.0, 1.0, 90.0, 90.0, 0.0)
    assert tbox.dodecahedron_vectors(2.5) == jbox.dodecahedron_vectors(2.5)


def test_tensor_functions_match_jax(cell):
    box, tilt, H = cell
    Hinv = np.linalg.inv(H)
    x = _points(1)
    Ht, Hit = torch.tensor(H, dtype=torch.float32), torch.tensor(Hinv, dtype=torch.float32)
    Hj, Hij = jnp.asarray(H, jnp.float32), jnp.asarray(Hinv, jnp.float32)
    np.testing.assert_allclose(
        tbox.latmul(torch.tensor(x), Hit).numpy(),
        np.asarray(jbox.latmul(jnp.asarray(x), Hij)), atol=ATOL)
    wt = tbox.wrap_frac(torch.tensor(x), Ht, Hit).numpy()
    wj = np.asarray(jbox.wrap_frac(jnp.asarray(x), Hj, Hij))
    # a point within rounding of a face may wrap to either side of it
    dw = (wt - wj) @ Hinv
    np.testing.assert_allclose(dw, np.round(dw), atol=1e-5)
    assert np.mean(np.abs(np.round(dw)).sum(1) == 0) > 0.98
    f = wt @ Hinv
    assert f.min() > -1e-5 and f.max() < 1.0 + 1e-5
    # displacements well inside half the smallest width: one image, no ties
    d = _points(2, scale=0.45 * float(np.min(tbox.perp_widths(H))) / np.sqrt(3.0))
    np.testing.assert_allclose(
        tbox.min_image_round(torch.tensor(d), Ht, Hit).numpy(),
        np.asarray(jbox.min_image_round(jnp.asarray(d), Hj, Hij)), atol=ATOL)
    far = _points(3)
    mt = tbox.min_image_exact(torch.tensor(far), H).numpy()
    mj = np.asarray(jbox.min_image_exact(jnp.asarray(far), H))
    # where two images tie within rounding either may be picked: compare lengths
    np.testing.assert_allclose(np.linalg.norm(mt, axis=1), np.linalg.norm(mj, axis=1),
                               atol=5e-6)
    # points reach 6 nm, more than two cells out: search five images a side
    shifts = np.array(list(np.ndindex(11, 11, 11))) - 5
    cand = far[:, None, :] + (shifts @ H)[None]
    np.testing.assert_allclose(np.linalg.norm(mt, axis=1),
                               np.linalg.norm(cand, axis=2).min(1), atol=5e-6)


def test_traced_matrices_and_widths(cell):
    box, tilt, H = cell
    ratios = (0.0, 0.0, 0.0) if tilt is None else tbox.tilt_ratios(box, tilt)
    bt = torch.tensor(box, dtype=torch.float32)
    Ht, Hit = tbox.traced_matrices(bt, ratios)
    Hj, Hij = jbox.traced_matrices(jnp.asarray(box, jnp.float32), ratios)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=ATOL)
    np.testing.assert_allclose(Hit.numpy(), np.asarray(Hij), atol=ATOL)
    np.testing.assert_allclose(Ht.numpy(), H, atol=ATOL)
    np.testing.assert_allclose((Ht @ Hit).numpy(), np.eye(3), atol=1e-6)
    np.testing.assert_allclose(
        tbox.traced_perp_widths(bt, ratios).numpy(),
        np.asarray(jbox.traced_perp_widths(jnp.asarray(box, jnp.float32), ratios)),
        atol=ATOL)
    np.testing.assert_allclose(tbox.traced_perp_widths(bt, ratios).numpy(),
                               tbox.perp_widths(H), atol=1e-5)
