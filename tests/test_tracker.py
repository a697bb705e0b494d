import contextlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from lane_tracker_tpu.tracker.config import PRESETS, ValidityConfig
from lane_tracker_tpu.tracker.tracker import LaneTracker

REF = pathlib.Path("/root/reference")

DEMO1_KW = dict(
    ksize_r=15, C_r=8, ksize_b=35, C_b=5, filter_type="bilateral",
    mask_noise=True, noise_thresh=140, ksize_noise=65, C_noise=10,
    window_width=30, window_height=40, search_range=20, mu=0.1,
    no_success_limit=50, start_slice=0.25, ignore_sides=360,
    ignore_bottom=30, bandwidth=30, partial=1.0, n_tries=2,
)


@contextlib.contextmanager
def _numpy_2017_shims():
    """Minimal in-memory compat shims so the 2017-era reference runs on
    modern NumPy (float linspace num, np.int alias). The reference files
    are never modified."""
    orig_linspace = np.linspace
    had_int = hasattr(np, "int")

    def linspace(start, stop, num=50, **kw):
        return orig_linspace(start, stop, int(num), **kw)

    np.linspace = linspace
    if not had_int:
        np.int = int
    try:
        yield
    finally:
        np.linspace = orig_linspace
        if not had_int and hasattr(np, "int"):
            del np.int


@pytest.fixture(scope="session")
def ref_process_module():
    if not (REF / "lane_tracker.py").exists():
        pytest.skip("reference checkout not available")
    sys.path.insert(0, str(REF))
    spec = importlib.util.spec_from_file_location(
        "ref_lane_tracker_proc", REF / "lane_tracker.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _make_ref_tracker(ref_process_module, calib, **kw):
    cam, warp = calib
    return ref_process_module.LaneTracker(
        warp.image_width_height,
        warp.warped_width_height,
        cam.cam_matrix,
        cam.dist_coeffs,
        (warp.M, warp.Minv),
        (warp.mppv, warp.mpph),
        **kw,
    )


def _make_jax_tracker(calib, validity=None, pipeline="compat"):
    cam, warp = calib
    return LaneTracker(
        warp.image_width_height,
        warp.warped_width_height,
        cam.cam_matrix,
        cam.dist_coeffs,
        (warp.M, warp.Minv),
        (warp.mppv, warp.mpph),
        validity=validity,
        pipeline=pipeline,
    )


def _band_patch(ref_lt):
    """Replace the reference band_search with an equivalent implementation
    (its float-slice indexing crashes on modern NumPy; semantics verified
    separately in test_search.py::test_band_search_matches_oracle)."""
    import types

    def band_search(self, img, bandwidth, ignore_bottom=30, partial=1,
                    diagnostics=False):
        if diagnostics:
            print("Using band search.")
        work = np.copy(img)
        work[work.shape[0] - ignore_bottom :, :] = 0
        work[: int(work.shape[0] * (1 - partial)), :] = 0
        yy, xx = np.nonzero(work)
        keep = {}
        for side, coeffs in (("left", self.last_left_coeffs),
                             ("right", self.last_right_coeffs)):
            px = coeffs[0] * yy.astype(np.float64) ** 2 + coeffs[1] * yy + coeffs[2]
            keep[side] = (xx > px - bandwidth) & (xx < px + bandwidth)
        if xx[keep["left"]].size and xx[keep["right"]].size:
            self.left_y, self.left_x = yy[keep["left"]], xx[keep["left"]]
            self.right_y, self.right_x = yy[keep["right"]], xx[keep["right"]]
            self.detected_pixels = True
            if diagnostics:
                print("Lane pixels found.")
        else:
            self.detected_pixels = False
            if diagnostics:
                print("No lane pixels found.")

    ref_lt.band_search = types.MethodType(band_search, ref_lt)


@pytest.mark.parametrize("order", [("frame911.jpg", "frame971.jpg")])
def test_tracker_matches_reference_process(ref_process_module, calib, order):
    """Full process() parity over the warm-start frame pair: detection
    flags, success counters, and coefficient curves within 0.5 px RMSE."""
    from PIL import Image
    from tests.conftest import ASSETS_DIR

    ref_lt = _make_ref_tracker(ref_process_module, calib)
    _band_patch(ref_lt)
    jax_lt = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity,
                               pipeline="compat")

    # Apply demo1 validity thresholds to the reference via check_validity
    # monkeypatching is impossible (hardcoded constants) — instead compare
    # under the committed thresholds for both.
    jax_lt2 = _make_jax_tracker(calib, pipeline="compat")

    H = 1100
    for name in order:
        frame = np.asarray(Image.open(ASSETS_DIR / name).convert("RGB"))
        with _numpy_2017_shims():
            ref_out = ref_lt.process(np.copy(frame), **DEMO1_KW)
        jax_out = jax_lt2.process(frame, **DEMO1_KW)
        assert jax_out.shape == ref_out.shape == frame.shape
        out = jax_lt2.last_output

        # Reference state vs ours
        assert bool(out.detected) == bool(ref_lt.detected_pixels)
        assert bool(out.valid) == bool(ref_lt.valid_lane_lines)
        if bool(out.valid):
            yy = np.arange(H, dtype=float)
            for mine, ref in (
                (np.asarray(out.left_coeffs, float), ref_lt.last_left_coeffs),
                (np.asarray(out.right_coeffs, float), ref_lt.last_right_coeffs),
            ):
                rmse = np.sqrt(
                    np.mean((np.polyval(mine, yy) - np.polyval(ref, yy)) ** 2)
                )
                assert rmse < 0.5, f"coefficient curve RMSE {rmse}"
            assert abs(int(out.radius) - ref_lt.average_curve_radius) <= max(
                3, 0.01 * ref_lt.average_curve_radius
            )
            assert abs(float(out.ecc) - ref_lt.eccentricity) < 0.02

    assert jax_lt2.get_success_ratio()[1:] == ref_lt.get_success_ratio()[1:]


def test_tracker_failure_grace_and_reset(calib):
    """Failure path state machine: grace-period rendering then failure
    message, and band -> sliding-window reset after n_reset misses."""
    jax_lt = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity)
    from PIL import Image
    from tests.conftest import ASSETS_DIR

    good = np.asarray(Image.open(ASSETS_DIR / "frame911.jpg").convert("RGB"))
    black = np.zeros_like(good)

    out1 = jax_lt.process(good, **DEMO1_KW)
    first_valid = bool(jax_lt.last_output.valid)
    assert first_valid
    assert int(jax_lt.last_output.search_mode) == 0  # first frame: sliding

    # Feed black frames: no pixels -> invalid; previous lane rendered for
    # n_fail frames, then the failure message.
    for i in range(1, 10):
        jax_lt.process(black, **DEMO1_KW)
        out = jax_lt.last_output
        assert not bool(out.valid)
        # Mode select reads last_detection at frame entry (pre-increment):
        # band while entry value i-1 <= n_reset=4, i.e. through i=5.
        if i <= 5:
            assert int(out.search_mode) == 1
        else:
            assert int(out.search_mode) == 0
        if i <= 8:  # n_fail = 8 -> previous lane still rendered
            assert int(out.render_mode) == 0
        else:
            assert int(out.render_mode) == 1

    ratio, succ, cnt = jax_lt.get_success_ratio()
    assert (succ, cnt) == (1, 10)


def test_tracker_state_snapshot_roundtrip(calib, tmp_path):
    from PIL import Image
    from tests.conftest import ASSETS_DIR

    frame = np.asarray(Image.open(ASSETS_DIR / "frame911.jpg").convert("RGB"))
    lt1 = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity)
    lt1.process(frame, **DEMO1_KW)
    lt1.save_state(tmp_path / "state.npz")

    lt2 = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity)
    lt2.load_state(tmp_path / "state.npz")
    # Continuing from the snapshot must give the same result as continuing
    # the original tracker.
    f2 = np.asarray(Image.open(ASSETS_DIR / "frame971.jpg").convert("RGB"))
    o1 = lt1.process(f2, **DEMO1_KW)
    o2 = lt2.process(f2, **DEMO1_KW)
    np.testing.assert_array_equal(o1, o2)
    assert int(lt1.last_output.search_mode) == 1  # warm start -> band


def test_tracker_multi_frame_trajectory_parity(ref_process_module, calib):
    """Six-frame trajectory through repeated hard frames: the tracker must
    follow the reference's exact wander (including the same validity flip)
    under demo1 thresholds, patched into the reference via the independent
    validity oracle."""
    import types

    from PIL import Image
    from tests.conftest import ASSETS_DIR
    from tests.test_polyfit import _validity_oracle

    v = PRESETS["demo1"].validity
    ref_lt = _make_ref_tracker(ref_process_module, calib)
    _band_patch(ref_lt)

    def check_validity(self, lc, rc, diagnostics=False):
        ly, lx, ry, rx = self.get_poly_points(lc, rc)
        self.valid_lane_lines = _validity_oracle(
            lc, rc, len(ly), len(ry), (1080, 1100), v
        )

    ref_lt.check_validity = types.MethodType(check_validity, ref_lt)
    jax_lt = _make_jax_tracker(calib, validity=v, pipeline="compat")

    f911 = np.asarray(Image.open(ASSETS_DIR / "frame911.jpg").convert("RGB"))
    f971 = np.asarray(Image.open(ASSETS_DIR / "frame971.jpg").convert("RGB"))
    yy = np.arange(1100, dtype=float)
    frames = [f911] + [f971] * 5
    for i, frame in enumerate(frames):
        with _numpy_2017_shims():
            ref_lt.process(np.copy(frame), **DEMO1_KW)
        jax_lt.process(frame, **DEMO1_KW)
        out = jax_lt.last_output
        assert bool(out.valid) == bool(ref_lt.valid_lane_lines), f"frame {i}"
        if bool(out.valid):
            for mine, ref in (
                (np.asarray(out.left_coeffs, float), ref_lt.last_left_coeffs),
                (np.asarray(out.right_coeffs, float), ref_lt.last_right_coeffs),
            ):
                rmse = np.sqrt(
                    np.mean((np.polyval(mine, yy) - np.polyval(ref, yy)) ** 2)
                )
                assert rmse < 0.5, f"frame {i}: curve RMSE {rmse}"
    assert jax_lt.get_success_ratio()[1:] == ref_lt.get_success_ratio()[1:]


def test_process_chunk_matches_process(calib):
    """The batched throughput API (process_chunk) produces the same
    per-frame results and state trajectory as the per-frame process()
    loop with identical kwargs."""
    from PIL import Image

    from tests.conftest import ASSETS_DIR

    kw = dict(mask_noise=True, noise_thresh=140, no_success_limit=50,
              bandwidth=30, ksize_r=15)
    lt_seq = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity,
                               pipeline="fast")
    lt_chunk = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity,
                                 pipeline="fast")

    f911 = np.asarray(Image.open(ASSETS_DIR / "frame911.jpg").convert("RGB"))
    f971 = np.asarray(Image.open(ASSETS_DIR / "frame971.jpg").convert("RGB"))
    frames = np.stack([f911, f971, f971, np.zeros_like(f911), f971, f911])

    seq_valid, seq_radius, seq_ecc = [], [], []
    for f in frames:
        lt_seq.process(f, **kw)
        out = lt_seq.last_output
        seq_valid.append(bool(out.valid))
        seq_radius.append(float(out.radius))
        seq_ecc.append(float(out.ecc))

    outs = lt_chunk.process_chunk(frames[:3], **kw)
    outs2 = lt_chunk.process_chunk(frames[3:], **kw)  # state carries over
    # Same kwargs -> ONE memoized processor (repeat chunks retrace nothing).
    assert len(lt_chunk._chunk_fns) == 1
    valid = np.concatenate([np.asarray(outs.valid), np.asarray(outs2.valid)])
    radius = np.concatenate([np.asarray(outs.radius), np.asarray(outs2.radius)])
    ecc = np.concatenate([np.asarray(outs.ecc), np.asarray(outs2.ecc)])

    assert valid.tolist() == seq_valid
    np.testing.assert_allclose(radius, seq_radius, rtol=1e-6)
    np.testing.assert_allclose(ecc, seq_ecc, rtol=1e-5, atol=1e-6)
    assert lt_chunk.get_success_ratio() == lt_seq.get_success_ratio()
    # Overlays match the per-frame path bit-exactly.
    ov_first = np.asarray(outs.overlay[0])
    lt_ref = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity,
                               pipeline="fast")
    lt_ref.process(frames[0], **kw)
    np.testing.assert_array_equal(
        ov_first, np.asarray(lt_ref.last_output.overlay))


def _split_numbers(line):
    """(template-with-placeholders, [floats]) for tolerance-aware diffs."""
    import re

    nums = []

    def repl(m):
        nums.append(float(m.group(0)))
        return "<num>"

    return re.sub(r"-?\d+(?:\.\d+)?", repl, line), nums


def test_diagnostics_transcript_matches_reference(ref_process_module, calib):
    """diagnostics=True narration parity with the live reference
    (lane_tracker.py:267, 441-447, 461, 497-500, 596-627, 1062-1143):
    the per-attempt search-mode / pixel-outcome / validity-criterion /
    attempt-verdict print sequence matches line for line over a sequence
    that exercises sliding-window, band search, a both-attempt failure and
    re-acquisition; numeric values agree within fit tolerance."""
    import io
    from contextlib import redirect_stdout

    from PIL import Image

    from tests.conftest import ASSETS_DIR

    # No corpus frame passes the reference's HARDCODED validity
    # thresholds (they match its demo videos, not these stills), so the
    # demo1 thresholds are applied to the reference via a check_validity
    # patch that replicates the reference's prints (format copied from
    # lane_tracker.py:596-627) with configurable bounds.
    import types

    from tests.test_polyfit import _validity_oracle

    cfg = PRESETS["demo1"]
    v = cfg.validity

    def patched_check_validity(self, lc, rc, diagnostics=False):
        ly, lx, ry, rx = self.get_poly_points(lc, rc)
        self.valid_lane_lines = _validity_oracle(
            lc, rc, len(ly), len(ry), (1080, 1100), v)
        if not diagnostics:
            return
        W = 1080 if v.y_eval_from_width else 1100
        nmin = min(len(ly), len(ry))
        y1, y2, y3 = W - 1, W - int(nmin * 0.35), W - int(nmin * 0.75)
        x1, x2, x3 = (
            abs(np.polyval(lc, y) - np.polyval(rc, y)) for y in (y1, y2, y3))
        dist = (
            "x1_diff == {:.2f}, x2_diff == {:.2f}, x3_diff == {:.2f} "
            "(min_dist_y1 == {}, max_dist_y1 == {}, min_dist_y2 == {}, "
            "max_dist_y2 == {}, min_dist_y3 == {}, max_dist_y3 == {})".format(
                x1, x2, x3, v.min_dist_y1, v.max_dist_y1, v.min_dist_y2,
                v.max_dist_y2, v.min_dist_y3, v.max_dist_y3))
        if (
            (x1 < v.min_dist_y1) | (x1 > v.max_dist_y1)
            | (x2 < v.min_dist_y2) | (x2 > v.max_dist_y2)
            | (x3 < v.min_dist_y3) | (x3 > v.max_dist_y3)
        ):
            print("No valid lane lines found, violated distance criterion: "
                  + dist)
            return
        d = lambda c, y: 2 * c[0] * y + c[1]  # noqa: E731
        norm1 = abs(d(lc, y1) - d(rc, y1))
        norm2 = abs(d(lc, y3) - d(rc, y3))
        tang = "norm1 == {:.3f}, norm2 == {:.3f} (thresh == {})".format(
            norm1, norm2, v.tangent_thresh)
        if (norm1 >= v.tangent_thresh) | (norm2 >= v.tangent_thresh):
            print("No valid lane lines found, violated tangent criterion: "
                  + tang + ". Distance: " + dist)
        else:
            print("Valid lane lines found. Tangents: " + tang
                  + ". Distance: " + dist)

    ref_lt = _make_ref_tracker(ref_process_module, calib)
    _band_patch(ref_lt)
    ref_lt.check_validity = types.MethodType(patched_check_validity, ref_lt)
    jax_lt = _make_jax_tracker(calib, validity=cfg.validity,
                               pipeline="compat")

    seq = ["frame911.jpg", "frame971.jpg", "black", "test1.jpg"]
    frames = {
        name: (np.zeros((720, 1280, 3), np.uint8) if name == "black"
               else np.asarray(Image.open(ASSETS_DIR / name).convert("RGB")))
        for name in seq
    }

    ref_log, jax_log = io.StringIO(), io.StringIO()
    kw = dict(DEMO1_KW)
    for name in seq:
        with _numpy_2017_shims(), redirect_stdout(ref_log):
            ref_lt.process(np.copy(frames[name]), diagnostics=True, **kw)
        with redirect_stdout(jax_log):
            jax_lt.process(frames[name], diagnostics=True, **kw)

    ref_lines = ref_log.getvalue().strip().splitlines()
    jax_lines = jax_log.getvalue().strip().splitlines()
    assert len(ref_lines) == len(jax_lines), (ref_lines, jax_lines)
    for rl, tl in zip(ref_lines, jax_lines):
        rt, rn = _split_numbers(rl)
        tt, tn = _split_numbers(tl)
        assert rt == tt, (rl, tl)
        # Values printed at {:.2f}/{:.3f} from independently fitted
        # coefficients: allow the <0.5 px fit tolerance on distances and
        # a matching slack on tangent norms and thresholds.
        for a, b in zip(rn, tn):
            assert abs(a - b) <= max(1.0, 0.02 * abs(a)), (rl, tl)
    # The sequence must exercise every narration branch.
    text = "\n".join(ref_lines)
    assert "Using sliding window search." in text
    assert "Using band search." in text
    assert "No success at first attempt, now trying second." in text
    assert "No success after all attempts." in text
    assert "Success at first attempt!" in text


def test_latency_mode_bit_identical(calib, frame_pair):
    """LaneTracker(latency_mode=True) swaps the resampler for the
    tile-structured rowmm path (round-5 latency mode) — the per-frame
    outputs must be bit-identical to the default tracker's."""
    from lane_tracker_tpu.tracker.config import PRESETS
    from lane_tracker_tpu.tracker.tracker import LaneTracker

    cam, warp = calib
    kwargs = dict(
        img_size=warp.image_width_height,
        warped_size=warp.warped_width_height,
        cam_matrix=cam.cam_matrix,
        dist_coeffs=cam.dist_coeffs,
        warp_matrices=(warp.M, warp.Minv),
        mpp_conversion=(warp.mppv, warp.mpph),
        validity=PRESETS["demo1"].validity,
    )
    base = LaneTracker(**kwargs)
    lat = LaneTracker(latency_mode=True, **kwargs)
    assert lat.params.mm_warp is not None
    for frame in frame_pair:
        out_b = base.process(frame, mask_noise=True, no_success_limit=50,
                             bandwidth=30)
        out_l = lat.process(frame, mask_noise=True, no_success_limit=50,
                            bandwidth=30)
        np.testing.assert_array_equal(out_b, out_l)
    assert lat.get_success_ratio() == base.get_success_ratio()
