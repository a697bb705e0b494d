"""The 'half' measured-approximation pipeline (round-4 verdict item 2:
the reduced-resolution filter/warp stage).

Structure: 'half' is 'fast' run at a scaled calibration — M_h = S @ M
with S the half-resolution pixel-center map, warped size halved, m/px
doubled, px-denominated config knobs halved (config.halve_config), SE
sizes odd-halved.  The filter ops themselves are the production ones with
parametrized SE sizes (pinned against cv2 at the 'half' sizes in
tests/test_filters.py), so the obligations here are the config scaling
rules; the content-dependent resolution deviation is measured by
scripts/approx_quality.py.
"""

import numpy as np
import pytest

from lane_tracker_tpu.calib.io import load_calibration_npz
from lane_tracker_tpu.tracker.config import (
    PRESETS,
    SECOND_ATTEMPT,
    SECOND_ATTEMPT_HALF,
    halve_config,
)
from lane_tracker_tpu.tracker.step import TrackerParams


def test_halve_config_rules():
    cfg = PRESETS["demo1"]
    h = halve_config(cfg)
    # Odd window/SE sizes floor-halve to the nearest odd, floor 3.
    assert h.filter.ksize_r == (cfg.filter.ksize_r // 2) | 1
    assert h.filter.ksize_b == (cfg.filter.ksize_b // 2) | 1
    assert h.filter.tophat_r == 14 | 1  # 29 -> 15
    assert h.filter.tophat_b == 27
    assert h.filter.open_k == 3  # 5 -> max(3, 2|1)
    # Intensity offsets and fractions are scale-free.
    assert h.filter.C_r == cfg.filter.C_r
    assert h.filter.noise_thresh == cfg.filter.noise_thresh
    assert h.search.mu == cfg.search.mu
    assert h.search.start_slice == cfg.search.start_slice
    assert h.validity.tangent_thresh == cfg.validity.tangent_thresh
    # Pixel distances halve exactly.
    assert h.search.ignore_sides == cfg.search.ignore_sides // 2
    assert h.validity.max_dist_y1 == cfg.validity.max_dist_y1 / 2
    # Frame-count policies stay put.
    assert h.n_fail == cfg.n_fail and h.n_tries == cfg.n_tries
    # The committed hardcoded second attempt set is the halved original.
    assert SECOND_ATTEMPT_HALF == halve_config(SECOND_ATTEMPT)


def test_half_params_geometry():
    cam, warp = load_calibration_npz("assets/calibration.npz")
    p = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="half",
    )
    assert p.res_scale == 2
    W, H = warp.warped_width_height
    assert p.warped_size == (W // 2, H // 2)
    # The unwarp grid maps the HALF warped space back to the full camera
    # image (overlay render stays full-res).
    assert p.unwarp_grid.base.shape == (warp.image_width_height[1],
                                        warp.image_width_height[0])
    # Metric conversions double so radius/ecc stay in meters.
    assert p.mppv == pytest.approx(warp.mppv * 2)
    assert p.mpph == pytest.approx(warp.mpph * 2)


@pytest.mark.slow
def test_half_tracks_near_fast():
    """End-to-end: 'half' must track the warm-start pair (valid both
    frames) with fitted curves near 'fast' after rescaling to full-res
    warped coordinates.  The tight quality budget is measured content-
    wide by scripts/approx_quality.py; this pins the wiring (config halving,
    scaled second attempt, coefficient spaces)."""
    from PIL import Image

    import lane_tracker_tpu as lt
    from scripts.approx_quality import rescale_coeffs
    from tests.test_tracker import DEMO1_KW, _make_jax_tracker

    calib = load_calibration_npz("assets/calibration.npz")
    frames = [np.asarray(Image.open(f"assets/{n}").convert("RGB"))
              for n in ("frame911.jpg", "frame971.jpg")]

    coeffs = {}
    for pipeline in ("fast", "half"):
        t = _make_jax_tracker(calib, validity=lt.PRESETS["demo1"].validity,
                              pipeline=pipeline)
        for f in frames:
            t.process(f, **DEMO1_KW)
            assert bool(t.last_output.valid), pipeline
        out = t.last_output
        lc = np.asarray(out.left_coeffs, float)
        rc = np.asarray(out.right_coeffs, float)
        if pipeline == "half":
            lc, rc = rescale_coeffs(lc, 2), rescale_coeffs(rc, 2)
        coeffs[pipeline] = (lc, rc)
        # Radius in meters is resolution-independent up to the fit noise.
        assert 1000 < float(out.radius) < 6000, pipeline

    yy = np.arange(1100, dtype=float)
    for side in (0, 1):
        diff = np.abs(np.polyval(coeffs["half"][side], yy)
                      - np.polyval(coeffs["fast"][side], yy))
        assert diff.max() < 6.0, (side, diff.max())
