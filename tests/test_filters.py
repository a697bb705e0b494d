import numpy as np
import pytest

from tests.conftest import requires_cv2

from lane_tracker_tpu.calib.homography import perspective_grid
from lane_tracker_tpu.calib.undistort import undistort_grid
from lane_tracker_tpu.kernels.resample import ResampleGrid, bilinear_gather
from lane_tracker_tpu.ops.color import rgb2lab_b_u8
from lane_tracker_tpu.ops.filters import (
    filter_lane_points,
    filter_lane_points_channels,
)
from lane_tracker_tpu.tracker.config import SECOND_ATTEMPT


@pytest.fixture(scope="module")
def warped_frame(calib, test_frame):
    """test4.jpg undistorted + warped to bird's-eye via the compat chain."""
    cam, warp = calib
    g1 = ResampleGrid.from_quantized(
        undistort_grid(cam.cam_matrix, cam.dist_coeffs, warp.image_width_height)
    )
    g2 = ResampleGrid.from_quantized(
        perspective_grid(warp.M, warp.image_width_height, warp.warped_width_height)
    )
    return np.asarray(bilinear_gather(bilinear_gather(test_frame, g1), g2))


def _cv2_filter_oracle(warped, **kwargs):
    """Oracle for the filter stage built from cv2 primitives + a direct
    numpy cross-threshold (structured independently of the reference)."""
    import cv2

    b_chan = cv2.cvtColor(warped, cv2.COLOR_RGB2LAB)[:, :, 2]
    return _cv2_channels_oracle(warped[:, :, 0], b_chan, **kwargs)


def _cv2_channels_oracle(
    r_chan,
    b_chan,
    filter_type="bilateral",
    ksize_r=25,
    C_r=8,
    ksize_b=35,
    C_b=5,
    mask_noise=False,
    ksize_noise=65,
    C_noise=10,
    noise_thresh=135,
    tophat_r=29,
    tophat_b=55,
    open_k=5,
):
    import cv2

    from tests.test_threshold import _cross_oracle

    if filter_type == "bilateral":
        se_r = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (tophat_r,) * 2)
        se_b = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (tophat_b,) * 2)
        r_feat = cv2.morphologyEx(r_chan, cv2.MORPH_TOPHAT, se_r)
        b_feat = cv2.morphologyEx(b_chan, cv2.MORPH_TOPHAT, se_b)
        r_th = _cross_oracle(r_feat, ksize_r, C_r, "floor")
        b_th = _cross_oracle(b_feat, ksize_b, C_b, "floor")
    else:
        r_th = cv2.adaptiveThreshold(
            r_chan, 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY, ksize_r, -C_r
        )
        b_th = cv2.adaptiveThreshold(
            b_chan, 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY, ksize_b, -C_b
        )
    merged = (r_th > 0) | (b_th > 0)
    if mask_noise:
        part1 = cv2.inRange(b_chan, noise_thresh, 255)
        part2 = _cross_oracle(b_chan, ksize_noise, C_noise, "floor")
        merged = merged & ((part1 == 0) | (part2 > 0))
    merged_u8 = np.where(merged, 255, 0).astype(np.uint8)
    se_open = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (open_k,) * 2)
    return cv2.morphologyEx(merged_u8, cv2.MORPH_OPEN, se_open)


def _channels(warped):
    return warped[:, :, 0], np.asarray(rgb2lab_b_u8(warped))


@requires_cv2
@pytest.mark.parametrize(
    "kwargs",
    [
        dict(filter_type="bilateral", mask_noise=False),
        dict(filter_type="bilateral", mask_noise=True),
        dict(filter_type="neighborhood", ksize_r=15, C_r=5),
    ],
    ids=["bilateral", "bilateral_noise", "neighborhood"],
)
def test_filter_stage_bit_exact_vs_cv2_oracle(warped_frame, kwargs):
    expected = _cv2_filter_oracle(warped_frame, **kwargs)
    mine = np.asarray(filter_lane_points(warped_frame, **kwargs))
    np.testing.assert_array_equal(expected, mine)


@requires_cv2
def test_filter_stage_white_pixel_plausibility(warped_frame):
    """The binary output must isolate a plausible fraction of lane pixels
    (sanity band around the measured reference behavior on test4.jpg)."""
    out = np.asarray(filter_lane_points(warped_frame, filter_type="bilateral"))
    n_white = int((out > 0).sum())
    total = out.size
    assert 0.01 < n_white / total < 0.25


@requires_cv2
def test_filter_stage_half_se_sizes_vs_cv2(warped_frame):
    """The XLA chain with the 'half' pipeline's structuring elements
    (tophat 15/27, open 3) and its halved windows stays bit-exact."""
    r, b = _channels(warped_frame)
    kw = dict(filter_type="bilateral", ksize_r=13, C_r=8, ksize_b=17,
              C_b=5, mask_noise=True, ksize_noise=33, C_noise=10,
              noise_thresh=135, tophat_r=15, tophat_b=27, open_k=3)
    expected = _cv2_channels_oracle(r, b, **kw)
    mine = np.asarray(filter_lane_points_channels(r, b, **kw))
    np.testing.assert_array_equal(expected, mine)


@requires_cv2
@pytest.mark.parametrize("mask_noise", [False, True], ids=["plain", "noise"])
def test_second_attempt_stage_vs_cv2(warped_frame, mask_noise):
    """The hardcoded second attempt's 'neighborhood' stage
    (lane_tracker.py:1081-1099), with and without the noise mask."""
    f = SECOND_ATTEMPT.filter
    kw = dict(filter_type=f.filter_type, ksize_r=f.ksize_r, C_r=f.C_r,
              ksize_b=f.ksize_b, C_b=f.C_b, mask_noise=mask_noise,
              ksize_noise=f.ksize_noise, C_noise=f.C_noise,
              noise_thresh=f.noise_thresh)
    r, b = _channels(warped_frame)
    expected = _cv2_channels_oracle(r, b, **kw)
    mine = np.asarray(filter_lane_points_channels(r, b, **kw))
    np.testing.assert_array_equal(expected, mine)
