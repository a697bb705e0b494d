"""The 'corridor' measured-approximation pipeline (round-4 verdict item 2:
the column analogue of the row ROI, tracker/step._roi_grids).

Exactness structure: the kept columns' warped channels are bit-identical
to 'fast' (host-side grid cropping), and on content whose lane pixels sit
inside the corridor the full decision trace matches 'fast' exactly.  The
per-frame ``corridor_ok`` certificate says when that holds.
"""

import numpy as np
import pytest

import jax

from lane_tracker_tpu.calib.io import load_calibration_npz
from lane_tracker_tpu.tracker.config import PRESETS
from lane_tracker_tpu.tracker.step import TrackerParams, make_initial_state


def test_corridor_params_crop_grids():
    cam, warp = load_calibration_npz("assets/calibration.npz")
    p = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="corridor",
    )
    assert p.col_roi == (320, 832)
    assert p.col_comp == (240, 912)  # corridor + 80 px influence margin
    assert p.grid_warp_roi.base.shape == (1100, 672)
    with pytest.raises(ValueError, match="col_roi"):
        TrackerParams.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height,
            warp.mppv, warp.mpph, pipeline="corridor", col_roi=(900, 1200),
        )


@pytest.mark.slow
def test_corridor_matches_fast_on_nominal_content():
    """On the bench stills (lanes at x 420-760, well inside [320, 832))
    the corridor trace must be IDENTICAL to 'fast': same validity,
    search mode, attempt counts, and fitted coefficients."""
    from PIL import Image

    from lane_tracker_tpu.parallel.pipeline import chunk_process

    cam, warp = load_calibration_npz("assets/calibration.npz")
    p_fast = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="fast")
    p_cor = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="corridor")
    config = PRESETS["demo1"]

    names = ["frame911.jpg", "frame971.jpg", "test4.jpg",
             "straight_lines1.jpg"]
    frames = np.stack([
        np.asarray(Image.open(f"assets/{n}").convert("RGB")) for n in names
    ])

    outs = {}
    for tag, p in (("fast", p_fast), ("corridor", p_cor)):
        st = make_initial_state(config, p.warped_size)
        _, o = jax.jit(lambda s, f, pp: chunk_process(
            s, f, pp, config, True, second_attempt="two_phase"),
            static_argnames=())(st, frames, p)
        outs[tag] = o

    for name in ("valid", "detected", "search_mode", "n_attempts",
                 "left_coeffs", "right_coeffs", "radius", "ecc",
                 "overlay"):
        np.testing.assert_array_equal(
            np.asarray(getattr(outs["fast"], name)),
            np.asarray(getattr(outs["corridor"], name)),
            err_msg=name,
        )
    assert np.asarray(outs["fast"].valid).all()
    # The exactness certificate must hold on nominal content (and 'fast'
    # reports constant True).
    assert np.asarray(outs["corridor"].corridor_ok).all()
    assert np.asarray(outs["fast"].corridor_ok).all()


@pytest.mark.slow
def test_corridor_certificate_flags_narrow_corridor():
    """A corridor too narrow for the content must clear corridor_ok: the
    bench stills' SWS seed histogram reads [360, 720), so a (430, 700)
    corridor cannot certify — the reads poke outside it."""
    from PIL import Image

    from lane_tracker_tpu.parallel.pipeline import chunk_process

    cam, warp = load_calibration_npz("assets/calibration.npz")
    p = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="corridor", col_roi=(430, 700))
    config = PRESETS["demo1"]
    frames = np.stack([
        np.asarray(Image.open("assets/frame911.jpg").convert("RGB"))])
    st = make_initial_state(config, p.warped_size)
    _, o = jax.jit(lambda s, f, pp: chunk_process(
        s, f, pp, config, False, second_attempt="two_phase"),
        static_argnames=())(st, frames, p)
    assert not np.asarray(o.corridor_ok).any()
