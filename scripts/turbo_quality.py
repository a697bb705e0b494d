"""Measure the 'turbo' pipeline's quality against the live reference.

'turbo' (tracker/step._warp_channels) computes LAB-B on the undistorted
band and warps it as a channel (one pair gather) instead of recomputing
LAB on the warped frame — the interpolate(LAB) vs LAB(interpolate)
reordering the reference's chain (lane_tracker.py:832-834, 207-208)
does not admit exactly.  The round-3/4 doctrine is to MEASURE
approximation candidates against the north star's 0.5 px RMSE budget
(BASELINE.md) instead of declining them a priori; this script produces
the evidence row: per-frame valid/detected trace mismatches and fitted
curve RMSE vs the live reference over the continuous-motion sequence.

Usage: nohup python scripts/turbo_quality.py [n_frames] > /tmp/turbo_q.log &
"""

import importlib.util
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def main(n_frames=300, chunk=50):
    from scripts.motion_longrun import motion_sequence
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

    spec = importlib.util.spec_from_file_location(
        "ref_lane_tracker_turbo", "/root/reference/lane_tracker.py")
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
    ref_valid, ref_detected = [], []
    ref_left, ref_right = [], []
    with _numpy_2017_shims():
        for t, frame in motion_sequence(n_frames):
            ref.process(np.copy(frame), **DEMO1_KW)
            ref_valid.append(bool(ref.valid_lane_lines))
            ref_detected.append(bool(ref.detected_pixels))
            ref_left.append(np.array(ref.last_left_coeffs, float)
                            if ref_valid[-1] else None)
            ref_right.append(np.array(ref.last_right_coeffs, float)
                             if ref_valid[-1] else None)
            if t % 100 == 99:
                print(f"  ref {t + 1}/{n_frames}", flush=True)
    ref_ratio = tuple(ref.get_success_ratio()[1:])

    print("turbo side (chunked pipeline, CPU backend) ...", flush=True)
    jt = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity,
                            pipeline="turbo")
    my_valid, my_left, my_right = [], [], []
    buf = []
    for t, frame in motion_sequence(n_frames):
        buf.append(frame)
        if len(buf) == chunk or t == n_frames - 1:
            outs = jt.process_chunk(np.stack(buf), with_overlay=False,
                                     **DEMO1_KW)
            my_valid.extend(bool(v) for v in np.asarray(outs.valid))
            my_left.extend(np.asarray(outs.left_coeffs, float))
            my_right.extend(np.asarray(outs.right_coeffs, float))
            buf = []
            print(f"  turbo {t + 1}/{n_frames}", flush=True)
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
    print(json.dumps({
        "pipeline": "turbo",
        "n_frames": n_frames,
        "ref_success": ref_ratio,
        "turbo_success": my_ratio,
        "n_valid_mismatch": len(vm),
        "valid_mismatch_frames": vm[:20],
        "rmse_px_max": round(max(rs), 4) if rs else None,
        "rmse_px_mean": round(float(np.mean(rs)), 4) if rs else None,
        "rmse_px_p99": (round(float(np.percentile(rs, 99)), 4)
                        if rs else None),
        "frames_over_0.5px": int(sum(r > 0.5 for r in rs)),
        "n_rmse_samples": len(rs),
    }), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 300)
