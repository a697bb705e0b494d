"""The lane-pixel isolation filter stage.

JAX re-design of ``LaneTracker.filter_lane_points``
(lane_tracker.py:183-240): channel extraction (RGB R + LAB B), elliptical
tophat morphology, bilateral-cross or block-mean adaptive thresholding, an
optional greenery noise mask, channel merge, and a 5x5 open.  Everything is
fixed-shape uint8/int32 math so the whole stage fuses under jit and batches
with vmap.

All structuring-element sizes match the reference's hardcoded constants
(lane_tracker.py:203-205): 29x29 for the R channel tophat, 55x55 for the
LAB-B tophat, 5x5 for the final open.
"""

from __future__ import annotations

import jax.numpy as jnp

from lane_tracker_tpu.ops.color import rgb2lab_b_u8
from lane_tracker_tpu.ops.morphology import open_ellipse, tophat_ellipse
from lane_tracker_tpu.ops.threshold import (
    adaptive_mean_threshold,
    bilateral_adaptive_threshold,
    in_range,
)

STREL_LAB_B = 55
STREL_RGB_R = 29
STREL_OPEN = 5


def filter_lane_points_channels(
    rgb_r: jnp.ndarray,
    lab_b: jnp.ndarray,
    filter_type: str = "bilateral",
    ksize_r: int = 25,
    C_r: int = 8,
    ksize_b: int = 35,
    C_b: int = 5,
    mask_noise: bool = False,
    ksize_noise: int = 65,
    C_noise: int = 10,
    noise_thresh: int = 135,
    tophat_r: int = STREL_RGB_R,
    tophat_b: int = STREL_LAB_B,
    open_k: int = STREL_OPEN,
) -> jnp.ndarray:
    """Filter stage operating on pre-extracted channels.

    Args:
        rgb_r: (H, W) uint8 R channel of the warped frame.
        lab_b: (H, W) uint8 LAB B channel of the warped frame.
        (remaining args as documented on LaneTracker.process)

    Returns:
        (H, W) uint8 binary image, 255 = lane candidate.
    """
    if filter_type == "bilateral":
        # Tophat feeds only the bilateral branch (the reference thresholds
        # the *raw* channels in 'neighborhood' mode, lane_tracker.py:216-218).
        r_feat = tophat_ellipse(rgb_r, tophat_r)
        b_feat = tophat_ellipse(lab_b, tophat_b)
        r_thresh = bilateral_adaptive_threshold(r_feat, ksize=ksize_r, C=C_r)
        b_thresh = bilateral_adaptive_threshold(b_feat, ksize=ksize_b, C=C_b)
    elif filter_type == "neighborhood":
        r_thresh = adaptive_mean_threshold(rgb_r, ksize_r, -C_r)
        b_thresh = adaptive_mean_threshold(lab_b, ksize_b, -C_b)
    else:
        raise ValueError("filter_type must be 'bilateral' or 'neighborhood'")

    merged = (r_thresh > 0) | (b_thresh > 0)

    if mask_noise:
        # Greenery suppression: high LAB-B intensity marks noise, but the
        # bilateral pass re-admits the yellow line (lane_tracker.py:221-231).
        noise_part1 = in_range(lab_b, noise_thresh, 255)
        noise_part2 = bilateral_adaptive_threshold(lab_b, ksize=ksize_noise, C=C_noise)
        keep = (~(noise_part1 > 0)) | (noise_part2 > 0)
        merged = merged & keep

    merged_u8 = jnp.where(merged, jnp.uint8(255), jnp.uint8(0))
    return open_ellipse(merged_u8, open_k)


def filter_lane_points(
    warped_rgb: jnp.ndarray,
    filter_type: str = "bilateral",
    ksize_r: int = 25,
    C_r: int = 8,
    ksize_b: int = 35,
    C_b: int = 5,
    mask_noise: bool = False,
    ksize_noise: int = 65,
    C_noise: int = 10,
    noise_thresh: int = 135,
) -> jnp.ndarray:
    """Full-parity filter stage on a warped (H, W, 3) uint8 RGB frame."""
    return filter_lane_points_channels(
        warped_rgb[..., 0],
        rgb2lab_b_u8(warped_rgb),
        filter_type=filter_type,
        ksize_r=ksize_r,
        C_r=C_r,
        ksize_b=ksize_b,
        C_b=C_b,
        mask_noise=mask_noise,
        ksize_noise=ksize_noise,
        C_noise=C_noise,
        noise_thresh=noise_thresh,
    )
