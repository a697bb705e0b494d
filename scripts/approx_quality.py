"""Measure an approximation pipeline's quality against the live reference.

Generalization of scripts/turbo_quality.py (round-4 verdict item 2: map
the fps-vs-RMSE frontier with MEASURED points, not extrapolation).  For a
given pipeline variant it runs the continuous-motion sequence through
both the live reference and the variant, and reports decision-trace
mismatches + fitted-curve RMSE vs the 0.5 px north-star budget
(BASELINE.md).  The curve variant (--curve) runs the evolving-curvature
generator instead — the content that killed turbo (4.62 px max).

Usage:
  nohup python scripts/approx_quality.py corridor [n_frames] [--curve] &
  nohup python scripts/approx_quality.py half 300 &

Results append to APPROX_BENCH.json at the repo root (one JSON line per
run — the committed frontier artifact).
"""

import importlib.util
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def rescale_coeffs(coeffs, s):
    """Map x(y) = c2 y^2 + c1 y + c0 fitted in s-times-downscaled warped
    coordinates to full-resolution warped coordinates.

    Pixel-center mapping: a full-res coordinate u corresponds to
    downscaled coordinate (u - (s-1)/2) / s (OpenCV resize convention),
    so x_f(y_f) = s * x_h((y_f - d)/s) + d with d = (s-1)/2.
    """
    c2, c1, c0 = float(coeffs[0]), float(coeffs[1]), float(coeffs[2])
    d = (s - 1) / 2.0
    # x_h(t) with t = (y_f - d)/s; x_f = s*x_h + d
    a2 = s * c2 / (s * s)
    a1 = s * (c1 / s - 2 * c2 * d / (s * s))
    a0 = s * (c2 * d * d / (s * s) - c1 * d / s + c0) + d
    return np.array([a2, a1, a0], float)


def main(argv):
    pipeline = argv[0]
    n_frames = int(argv[1]) if len(argv) > 1 and argv[1].isdigit() else 300
    curve = "--curve" in argv
    chunk = 50

    from scripts.motion_longrun import motion_sequence
    try:
        from scripts.motion_longrun import curve_sequence as curvature_sequence
    except ImportError:
        curvature_sequence = None
    from tests.test_corpus import _patch_validity
    from tests.test_tracker import (
        DEMO1_KW,
        _band_patch,
        _make_ref_tracker,
        _make_jax_tracker,
        _numpy_2017_shims,
    )

    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.tracker.config import PRESETS

    seq = (curvature_sequence if curve and curvature_sequence
           else motion_sequence)

    spec = importlib.util.spec_from_file_location(
        "ref_lane_tracker_aq", "/root/reference/lane_tracker.py")
    sys.path.insert(0, "/root/reference")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class M:
        LaneTracker = mod.LaneTracker

    calib = load_calibration_npz("assets/calibration.npz")
    ref = _make_ref_tracker(M, calib)
    _band_patch(ref)
    _patch_validity(ref, PRESETS["demo1"].validity)

    print(f"reference side: {n_frames} frames ...", flush=True)
    ref_valid, ref_left, ref_right = [], [], []
    with _numpy_2017_shims():
        for t, frame in seq(n_frames):
            ref.process(np.copy(frame), **DEMO1_KW)
            ref_valid.append(bool(ref.valid_lane_lines))
            ref_left.append(np.array(ref.last_left_coeffs, float)
                            if ref_valid[-1] else None)
            ref_right.append(np.array(ref.last_right_coeffs, float)
                             if ref_valid[-1] else None)
            if t % 100 == 99:
                print(f"  ref {t + 1}/{n_frames}", flush=True)
    ref_ratio = tuple(ref.get_success_ratio()[1:])

    print(f"{pipeline} side (chunked pipeline, CPU backend) ...", flush=True)
    jt = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity,
                            pipeline=pipeline)
    s = getattr(jt.params, "res_scale", 1) if hasattr(
        jt.params, "res_scale") else (2 if pipeline == "half" else 1)
    my_valid, my_left, my_right = [], [], []
    buf = []
    for t, frame in seq(n_frames):
        buf.append(frame)
        if len(buf) == chunk or t == n_frames - 1:
            outs = jt.process_chunk(np.stack(buf), with_overlay=False,
                                     **DEMO1_KW)
            my_valid.extend(bool(v) for v in np.asarray(outs.valid))
            for lc, rc in zip(np.asarray(outs.left_coeffs, float),
                              np.asarray(outs.right_coeffs, float)):
                if s != 1:
                    lc, rc = rescale_coeffs(lc, s), rescale_coeffs(rc, s)
                my_left.append(lc)
                my_right.append(rc)
            buf = []
            print(f"  {pipeline} {t + 1}/{n_frames}", flush=True)
    my_ratio = tuple(int(v) for v in jt.get_success_ratio()[1:])

    vm = [i for i, (a, b) in enumerate(zip(my_valid, ref_valid)) if a != b]
    yy = np.arange(1100, dtype=float)
    rs = []
    for t in range(n_frames):
        if not (ref_valid[t] and my_valid[t]):
            continue
        for mine, r in ((my_left[t], ref_left[t]),
                        (my_right[t], ref_right[t])):
            rs.append(float(np.sqrt(np.mean(
                (np.polyval(mine, yy) - np.polyval(r, yy)) ** 2))))
    rec = {
        "pipeline": pipeline,
        "content": "curve" if curve else "motion",
        "n_frames": n_frames,
        "ref_success": ref_ratio,
        "my_success": my_ratio,
        "n_valid_mismatch": len(vm),
        "valid_mismatch_frames": vm[:20],
        "rmse_px_max": round(max(rs), 4) if rs else None,
        "rmse_px_mean": round(float(np.mean(rs)), 4) if rs else None,
        "rmse_px_p99": (round(float(np.percentile(rs, 99)), 4)
                        if rs else None),
        "frames_over_0.5px": int(sum(r > 0.5 for r in rs)),
        "n_rmse_samples": len(rs),
    }
    print(json.dumps(rec), flush=True)
    with open("APPROX_BENCH.json", "a") as f:
        f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
