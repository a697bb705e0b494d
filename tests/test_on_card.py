"""Tests that need an NVIDIA GPU (marker ``gpu``): the exactness claims
that rest on what the GPU's compiler and math library choose.

They skip on other backends.  chip_smoke.py runs them on a card, in a child
process, with LT_TESTS_ON_CARD=1 (tests/conftest.py then leaves the platform
to JAX and turns a missing GPU into a failure):

    LT_TESTS_ON_CARD=1 python -m pytest tests/test_on_card.py -m gpu
"""

import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lane_tracker_tpu.ops.integrals import (
    build_row_prefixes,
    row_prefixes_reference,
)

pytestmark = pytest.mark.gpu

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"


@pytest.fixture(scope="module")
def stills():
    return np.load(ASSETS / "stills.npz")["frames"]


@pytest.mark.parametrize("W", [672, 1080, 1280])
def test_row_prefixes_exact_on_card(card, W):
    """The bf16 prefix matmul accumulates in f32 on the card: all-ones and
    random rows at the real widths equal the int64 reference."""
    rng = np.random.default_rng(W)
    binary = np.concatenate([
        np.full((64, W), 255, np.uint8),
        np.where(rng.random((64, W)) < 0.5, 255, 0).astype(np.uint8)])
    got = np.asarray(jax.jit(build_row_prefixes)(binary).packed)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  row_prefixes_reference(binary))


def test_lab_gamma_poly_exhaustive_on_card(card):
    """The polynomial gamma reproduces the integer LUT exactly under the
    card's FMA contraction (LP-certified margin, ops/color._gamma_poly)."""
    from lane_tracker_tpu.ops.color import _gamma_poly_f32, _tables

    gamma_tab, _, _ = _tables()
    i = jnp.arange(256, dtype=jnp.float32)
    got = np.asarray(jax.jit(_gamma_poly_f32)(i)).astype(np.int64)
    np.testing.assert_array_equal(got, gamma_tab)


def test_lab_b_fast_contract_on_card(card, stills):
    """The arithmetic LAB-B stays within <=1 unit on <0.1% of pixels of
    the LUT path with the card's transcendentals."""
    from lane_tracker_tpu.ops.color import rgb2lab_b_fast, rgb2lab_b_u8

    for img in stills:
        exact = np.asarray(jax.jit(rgb2lab_b_u8)(img)).astype(np.int32)
        fast = np.asarray(jax.jit(rgb2lab_b_fast)(img)).astype(np.int32)
        diff = np.abs(exact - fast)
        assert diff.max() <= 1
        assert (diff != 0).mean() < 1e-3


@pytest.mark.parametrize("filter_type", ["bilateral", "neighborhood"])
def test_filter_stage_matches_cpu_on_card(card, stills, filter_type):
    """The filter chain is integer arithmetic: the card's binary equals
    the CPU's, bit for bit, at the shipped warped size."""
    from lane_tracker_tpu.ops.filters import filter_lane_points_channels

    rng = np.random.default_rng(3)
    r = rng.integers(0, 256, (1100, 1080), np.uint8)
    b = rng.integers(0, 256, (1100, 1080), np.uint8)
    fn = jax.jit(lambda r, b: filter_lane_points_channels(
        r, b, filter_type=filter_type, ksize_r=15, C_r=8, ksize_b=35,
        C_b=5, mask_noise=True, noise_thresh=140))
    got = np.asarray(fn(r, b))
    cpu = jax.devices("cpu")[0]
    want = np.asarray(fn(*jax.device_put((r, b), cpu)))
    np.testing.assert_array_equal(got, want)


def test_rowmm_matches_gather_on_card(card, calib):
    """The latency-mode resampler's bf16 tensor-core contraction (the
    card's branch of kernels/resample_rowmm._taps_rowmm) is bit-identical
    to the per-pixel gather on the shipped warp grid."""
    from lane_tracker_tpu.kernels.resample import bilinear_gather_pair
    from lane_tracker_tpu.kernels.resample_rowmm import (
        bilinear_gather_pair_rowmm,
        build_rowmm,
    )
    from lane_tracker_tpu.tracker.step import TrackerParams

    cam, warp = calib
    p = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="fast")
    grid = p.grid_warp_roi
    mm = build_rowmm(grid)
    Ws, Hs = grid.src_size
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (Hs, Ws), dtype=np.uint8)
    b = rng.integers(0, 256, (Hs, Ws), dtype=np.uint8)
    ra, rb = jax.jit(bilinear_gather_pair)(a, b, grid)
    ma, mb = jax.jit(bilinear_gather_pair_rowmm)(a, b, grid, mm)
    np.testing.assert_array_equal(np.asarray(ra), np.asarray(ma))
    np.testing.assert_array_equal(np.asarray(rb), np.asarray(mb))
