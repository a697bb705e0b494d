"""Pins for the 'turbo' opt-in approximate pipeline.

'turbo' reorders the reference's warp->LAB chain (LAB-B computed on the
undistorted band, then warped as a channel with the out-of-image fill
bias) for one fewer packed take and a 4x smaller LAB, measured against
the live reference by scripts/turbo_quality.py.  It FAILS the 0.5 px max north-star budget (stills rmse max 1.36 px;
4.62 px over the 300-frame motion run — with ZERO validity-trace flips
in both), so it is not the headline — these tests pin the plumbing
contracts that make its measured quality reproducible, not reference
parity.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lane_tracker_tpu.calib.io import load_calibration_npz  # noqa: E402
from lane_tracker_tpu.tracker.step import (  # noqa: E402
    TrackerParams,
    _warp_channels,
)


@pytest.fixture(scope="module")
def calib():
    return load_calibration_npz("assets/calibration.npz")


def _params(calib, pipeline):
    cam, warp = calib
    return TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline=pipeline)


@pytest.fixture(scope="module")
def frame():
    from PIL import Image

    return jnp.asarray(
        np.asarray(Image.open("assets/frame911.jpg").convert("RGB")))


def test_turbo_r_channel_bit_exact(calib, frame):
    """The R channel goes through the identical two-stage chain (only the
    LAB channel is reordered), so it must match 'fast' bit-for-bit."""
    rf, _ = _warp_channels(frame, _params(calib, "fast"))
    rt, _ = _warp_channels(frame, _params(calib, "turbo"))
    assert np.array_equal(np.asarray(rf), np.asarray(rt))


def test_turbo_out_of_image_fill_is_128(calib, frame):
    """Out-of-image warp pixels must read LAB-B of black (128): the warp
    grid's out-of-bounds taps carry weight 0, so without the fill bias
    the warped LAB channel reads 0 there (a 128-unit error across ~13%
    of the frame — the bug the bias map exists to fix)."""
    p = _params(calib, "turbo")
    wsum = sum(np.asarray(w, np.float64) for w in (
        p.grid_warp_roi.w00, p.grid_warp_roi.w01,
        p.grid_warp_roi.w10, p.grid_warp_roi.w11))
    outside = wsum == 0.0
    assert outside.any(), "calibration warp should sample outside corners"
    _, bf = _warp_channels(frame, _params(calib, "fast"))
    _, bt = _warp_channels(frame, p)
    assert (np.asarray(bt)[outside] == 128).all()
    assert (np.asarray(bf)[outside] == 128).all()


def test_turbo_lab_close_to_fast_in_image(calib, frame):
    """In-image, the reordering error is a few units on blended edge
    pixels only — the bound under which the measured quality numbers
    (rmse max 1.36 px) were taken.  A regression past this bound means
    the turbo chain changed, so the measured row no longer applies."""
    _, bf = _warp_channels(frame, _params(calib, "fast"))
    _, bt = _warp_channels(frame, _params(calib, "turbo"))
    d = np.abs(np.asarray(bf).astype(int) - np.asarray(bt).astype(int))
    assert d.max() <= 6
    assert (d > 1).mean() < 0.005


def test_turbo_params_jit_roundtrip(calib, frame):
    """TrackerParams with the bias-map child must flatten/unflatten and
    pass through jit as an argument (the bias is a pytree leaf; the
    fleet/shard_map paths rely on the flatten order)."""
    p = _params(calib, "turbo")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    p2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert p2.pipeline == "turbo" and p2.warp_b_bias is not None

    # jit-to-jit: eager would differ at exact-half rounding boundaries
    # (jit may FMA-contract the weight dot differently).
    fn = jax.jit(_warp_channels)
    r1, b1 = fn(frame, p)
    r2, b2 = fn(frame, p2)
    assert np.array_equal(np.asarray(r1), np.asarray(r2))
    assert np.array_equal(np.asarray(b1), np.asarray(b2))
