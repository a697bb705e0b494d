import numpy as np
import pytest

from tests.conftest import requires_cv2

from lane_tracker_tpu.ops.color import rgb2lab_u8, rgb2lab_b_u8


@requires_cv2
def test_lab_exhaustive_grid_matches_cv2():
    import cv2

    rs = np.arange(0, 256, 2)
    grid = (
        np.stack(np.meshgrid(rs, rs, rs, indexing="ij"), axis=-1)
        .astype(np.uint8)
        .reshape(2048, -1, 3)
    )
    ref = cv2.cvtColor(grid, cv2.COLOR_RGB2LAB)
    mine = np.asarray(rgb2lab_u8(grid))
    np.testing.assert_array_equal(ref, mine)


@requires_cv2
def test_lab_random_matches_cv2(rng):
    import cv2

    img = rng.integers(0, 256, (257, 123, 3), dtype=np.uint8)
    ref = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    mine = np.asarray(rgb2lab_u8(img))
    np.testing.assert_array_equal(ref, mine)


@requires_cv2
def test_lab_b_channel_on_real_frame(test_frame):
    import cv2

    ref_b = cv2.cvtColor(test_frame, cv2.COLOR_RGB2LAB)[:, :, 2]
    mine_b = np.asarray(rgb2lab_b_u8(test_frame))
    np.testing.assert_array_equal(ref_b, mine_b)


def test_lab_shapes_and_dtype():
    img = np.zeros((8, 8, 3), dtype=np.uint8)
    out = np.asarray(rgb2lab_u8(img))
    assert out.shape == (8, 8, 3) and out.dtype == np.uint8
    b = np.asarray(rgb2lab_b_u8(img))
    assert b.shape == (8, 8) and b.dtype == np.uint8
    # black -> L=0, a=b=128
    assert out[0, 0, 0] == 0 and out[0, 0, 1] == 128 and out[0, 0, 2] == 128


def test_lab_b_fast_close_to_exact(test_frame, rng):
    """Arithmetic LAB (fast path) vs the bit-exact LUT pipeline.

    Since round 4 the gamma stage is rint-exact (polynomial, see
    test_lab_gamma_poly_exhaustive); the only remaining deviation is
    cbrt's rare boundary rounding — the original tolerance contract."""
    from lane_tracker_tpu.ops.color import rgb2lab_b_fast

    for img in (test_frame, rng.integers(0, 256, (300, 400, 3), np.uint8)):
        exact = np.asarray(rgb2lab_b_u8(img)).astype(np.int32)
        fast = np.asarray(rgb2lab_b_fast(img)).astype(np.int32)
        diff = np.abs(exact - fast)
        assert diff.max() <= 1
        assert (diff != 0).mean() < 1e-3


def test_lab_gamma_poly_exhaustive():
    """The fast path's polynomial gamma must reproduce the integer LUT
    EXACTLY on every reachable input, under jit on this backend (the
    LP-certified margin makes this FMA-contraction-proof; see
    _gamma_poly).  tests/test_on_card.py runs the same exhaustive check
    on a GPU."""
    import jax
    import jax.numpy as jnp

    from lane_tracker_tpu.ops.color import _gamma_poly_f32, _tables

    gamma_tab, _, _ = _tables()
    i = jnp.arange(256, dtype=jnp.float32)
    got_g = np.asarray(jax.jit(_gamma_poly_f32)(i)).astype(np.int64)
    np.testing.assert_array_equal(got_g, gamma_tab)


def test_lab_gamma_poly_bake_matches_lp_fit():
    """The baked _GAMMA_POLY_COEFS constants must equal a fresh LP fit
    (the product path carries no scipy dependency — round-4 advisor —
    so the refit lives here, skipped where scipy is absent) and must
    pass the both-FMA-orders rint-exactness verification."""
    from lane_tracker_tpu.ops.color import (
        _GAMMA_POLY_COEFS,
        _GAMMA_POLY_HALF,
        _GAMMA_POLY_MID,
        _verify_gamma_poly,
    )

    _verify_gamma_poly(_GAMMA_POLY_COEFS, _GAMMA_POLY_MID, _GAMMA_POLY_HALF)

    pytest.importorskip("scipy")
    from lane_tracker_tpu.ops.color import _fit_gamma_poly

    coefs, mid, half = _fit_gamma_poly()
    assert (mid, half) == (_GAMMA_POLY_MID, _GAMMA_POLY_HALF)
    # The LP solution is solver-dependent in its last digits; the bake
    # contract is that the FIT's own rint-exactness holds and the baked
    # coefficients stay within the certified margin of the fit.
    _verify_gamma_poly(coefs, mid, half)
    np.testing.assert_allclose(coefs, _GAMMA_POLY_COEFS, rtol=0, atol=1e-6)
