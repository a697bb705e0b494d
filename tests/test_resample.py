import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import requires_cv2

from lane_tracker_tpu.calib.homography import (
    get_perspective_transform,
    perspective_grid,
)
from lane_tracker_tpu.calib.undistort import (
    fused_undistort_warp_grid,
    undistort_grid,
)
from lane_tracker_tpu.kernels.resample import ResampleGrid, bilinear_gather


@requires_cv2
def test_get_perspective_transform_matches_cv2():
    import cv2

    src = np.array([(242, 695), (564, 473), (721, 473), (1064, 695)], np.float32)
    dst = np.array([(439, 1100), (439, 380), (643, 380), (643, 1100)], np.float32)
    ref = cv2.getPerspectiveTransform(src, dst)
    mine = get_perspective_transform(src, dst)
    np.testing.assert_allclose(ref, mine, rtol=1e-9, atol=1e-9)


@requires_cv2
def test_warp_perspective_matches_cv2(calib, test_frame):
    """OpenCV >= 5 warpPerspective uses full float bilinear; the float-mode
    grid reproduces it to <=1 intensity unit on <0.01% of pixels (residual
    f32 ulp effects in weight products)."""
    import cv2

    _, warp = calib
    ref = cv2.warpPerspective(
        test_frame,
        warp.M,
        warp.warped_width_height,
        flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT,
    )
    grid = ResampleGrid.from_quantized(
        perspective_grid(warp.M, warp.image_width_height, warp.warped_width_height)
    )
    mine = np.asarray(bilinear_gather(test_frame, grid))
    diff = np.abs(ref.astype(np.int32) - mine.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 5e-4


@requires_cv2
def test_undistort_bit_exact(calib, test_frame):
    import cv2

    cam, warp = calib
    ref = cv2.undistort(
        test_frame, cam.cam_matrix, cam.dist_coeffs, None, cam.cam_matrix
    )
    grid = ResampleGrid.from_quantized(
        undistort_grid(cam.cam_matrix, cam.dist_coeffs, warp.image_width_height)
    )
    mine = np.asarray(bilinear_gather(test_frame, grid))
    np.testing.assert_array_equal(ref, mine)


@requires_cv2
def test_two_stage_chain_matches_cv2(calib, test_frame):
    """undistort -> warp, chained through the gather kernel, matches cv2
    (undistort leg bit-exact; warp leg within the float-path tolerance)."""
    import cv2

    cam, warp = calib
    und = cv2.undistort(
        test_frame, cam.cam_matrix, cam.dist_coeffs, None, cam.cam_matrix
    )
    ref = cv2.warpPerspective(
        und,
        warp.M,
        warp.warped_width_height,
        flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT,
    )
    g1 = ResampleGrid.from_quantized(
        undistort_grid(cam.cam_matrix, cam.dist_coeffs, warp.image_width_height)
    )
    g2 = ResampleGrid.from_quantized(
        perspective_grid(warp.M, warp.image_width_height, warp.warped_width_height)
    )
    mine = np.asarray(bilinear_gather(bilinear_gather(test_frame, g1), g2))
    diff = np.abs(ref.astype(np.int32) - mine.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 5e-4


@requires_cv2
def test_fused_grid_close_to_two_stage(calib, test_frame):
    """The fused undistort+warp gather skips the intermediate resampling;
    it matches the exact chain on the bulk of the image, diverging only at
    strong edges in heavily magnified regions (single-resampling is the
    *sharper* of the two)."""
    import cv2

    cam, warp = calib
    und = cv2.undistort(
        test_frame, cam.cam_matrix, cam.dist_coeffs, None, cam.cam_matrix
    )
    ref = cv2.warpPerspective(
        und, warp.M, warp.warped_width_height, flags=cv2.INTER_LINEAR
    ).astype(np.int32)
    grid = ResampleGrid.from_quantized(
        fused_undistort_warp_grid(
            cam.cam_matrix,
            cam.dist_coeffs,
            warp.M,
            warp.image_width_height,
            warp.warped_width_height,
        )
    )
    mine = np.asarray(bilinear_gather(test_frame, grid)).astype(np.int32)
    diff = np.abs(ref - mine)
    # Resampling-order differences concentrate at strong edges in the
    # magnified near-field; the bulk of the image is identical.
    assert np.median(diff) == 0
    assert np.mean(diff) < 5.0
    assert (diff > 8).mean() < 0.05


def test_identity_warp_roundtrip():
    img = np.arange(64 * 48, dtype=np.uint8).reshape(48, 64) % 251
    grid = ResampleGrid.from_quantized(
        perspective_grid(np.eye(3), (64, 48), (64, 48))
    )
    np.testing.assert_array_equal(img, np.asarray(bilinear_gather(img, grid)))


def test_bilinear_gather_pair_matches_single():
    from lane_tracker_tpu.calib.synthetic import make_synthetic_calibration
    from lane_tracker_tpu.calib.undistort import fused_undistort_warp_grid
    from lane_tracker_tpu.kernels.resample import bilinear_gather_pair

    cam, warp = make_synthetic_calibration(img_size=(128, 96), warped_size=(96, 128))
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    b = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    for mode in ("float", "fixed"):
        grid = ResampleGrid.from_quantized(
            fused_undistort_warp_grid(
                cam.cam_matrix, cam.dist_coeffs, warp.M,
                warp.image_width_height, warp.warped_width_height, mode=mode,
            )
        )
        oa, ob = bilinear_gather_pair(a, b, grid)
        np.testing.assert_array_equal(np.asarray(oa), np.asarray(bilinear_gather(a, grid)))
        np.testing.assert_array_equal(np.asarray(ob), np.asarray(bilinear_gather(b, grid)))


def test_rowmm_taps_bit_exact_vs_gather(calib):
    """The tile-structured (slab + one-hot matmul) resampler must be
    bit-identical to the per-pixel gather on BOTH production grids —
    it exists purely as a faster tap-fetch strategy for unbatched
    frames (kernels/resample_rowmm.py; round-5 latency mode)."""
    from lane_tracker_tpu.kernels.resample import bilinear_gather_pair
    from lane_tracker_tpu.kernels.resample_rowmm import (
        bilinear_gather_pair_rowmm,
        bilinear_gather_rowmm,
        build_rowmm,
        gather_planes_rowmm,
    )
    from lane_tracker_tpu.tracker.step import TrackerParams

    cam, warp = calib
    p = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="fast",
    )
    rng = np.random.default_rng(5)
    for grid in (p.grid_warp_roi, p.grid_und_roi):
        mm = build_rowmm(grid)
        assert mm is not None  # both production grids are tile-structured
        Ws, Hs = grid.src_size
        a = rng.integers(0, 256, (Hs, Ws), dtype=np.uint8)
        b = rng.integers(0, 256, (Hs, Ws), dtype=np.uint8)
        ra, rb = bilinear_gather_pair(a, b, grid)
        ma, mb = bilinear_gather_pair_rowmm(a, b, grid, mm)
        np.testing.assert_array_equal(np.asarray(ra), np.asarray(ma))
        np.testing.assert_array_equal(np.asarray(rb), np.asarray(mb))
        m1 = bilinear_gather_rowmm(a, grid, mm)
        np.testing.assert_array_equal(
            np.asarray(bilinear_gather(a, grid)), np.asarray(m1))
        pl = gather_planes_rowmm(jnp.stack([a, b]), grid, mm)
        np.testing.assert_array_equal(np.asarray(ra), np.asarray(pl[0]))
        np.testing.assert_array_equal(np.asarray(rb), np.asarray(pl[1]))


def test_rowmm_chunk_pipeline_bit_exact(calib, frame_pair):
    """with_rowmm() params must leave the whole chunk pipeline
    bit-identical (overlay, coefficients, validity) — the latency mode
    changes WHERE taps come from, never what they are."""
    from lane_tracker_tpu.parallel.pipeline import build_chunk_processor
    from lane_tracker_tpu.tracker.config import PRESETS
    from lane_tracker_tpu.tracker.step import (
        TrackerParams,
        make_initial_state,
    )

    cam, warp = calib
    chunk = np.stack(frame_pair)
    config = PRESETS["demo1"]
    p = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="corridor",
    )
    pm = p.with_rowmm()
    assert pm.mm_warp is not None and pm.mm_und is not None
    step = build_chunk_processor(config, with_overlay=True,
                                 second_attempt="two_phase")
    s0 = make_initial_state(config, p.warped_size)
    _, o1 = step(s0, chunk, p)
    _, o2 = step(s0, chunk, pm)
    np.testing.assert_array_equal(np.asarray(o1.overlay),
                                  np.asarray(o2.overlay))
    np.testing.assert_array_equal(np.asarray(o1.left_coeffs),
                                  np.asarray(o2.left_coeffs))
    np.testing.assert_array_equal(np.asarray(o1.right_coeffs),
                                  np.asarray(o2.right_coeffs))
    np.testing.assert_array_equal(np.asarray(o1.valid), np.asarray(o2.valid))
    assert bool(np.asarray(o2.valid).all())
