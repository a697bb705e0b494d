"""Continuous-motion long run vs the live reference (round-2 verdict #7).

The corpus/longrun oracle tests splice stills, so every warm-start frame
is pixel-identical to its predecessor and band search never tracks
MOVING content at scale.  This synthesizes a ~1,200-frame sequence with
real inter-frame motion — smooth affine pan/zoom/rotation jitter of
corpus frames (amplitudes a few px/frame, like real road vibration) plus
black dropouts — runs BOTH the live reference (with the oracle-test
shims/patches) and this package's chunked pipeline over it, and compares
the per-frame detected/valid traces exactly, plus the final success
ratio.

Every frame is unique, so the reference's filter memoization does not
apply: expect ~200 ms/frame on the reference side and ~1-2 s/frame for
the repo's XLA chain on the CPU backend (~30-40 min total).
tests/test_longrun.py runs a short segment of the same generator as a
-m slow test.

Usage: nohup python scripts/motion_longrun.py [n_frames] > /tmp/motion.log &
"""

import json
import sys

import numpy as np

sys.path.insert(0, ".")


def motion_sequence(n_frames, seed=7):
    """Yield (index, frame) for a smoothly-jittered corpus drive.

    Segments rotate through three corpus scenes; within a segment the
    source image is warped by a slowly-varying affine (pan up to ~6 px,
    rotation up to ~0.3 deg, zoom up to ~0.5%) with reflected borders, so
    consecutive frames differ the way consecutive dashcam frames do.
    Two black dropouts exercise failure/recovery on moving content.
    """
    import cv2
    from PIL import Image

    bases = [
        np.asarray(Image.open(f"assets/{n}").convert("RGB"))
        for n in ("frame911.jpg", "frame971.jpg", "test4.jpg")
    ]
    H, W = bases[0].shape[:2]
    seg = 150
    dropouts = {(3, k) for k in range(6)} | {(6, k) for k in range(3)}
    for t in range(n_frames):
        s, k = divmod(t, seg)
        if (s, k) in dropouts:
            yield t, np.zeros_like(bases[0])
            continue
        base = bases[s % len(bases)]
        dx = 6.0 * np.sin(2 * np.pi * t / 173.0)
        dy = 2.5 * np.sin(2 * np.pi * t / 97.0)
        ang = 0.3 * np.sin(2 * np.pi * t / 211.0)
        zoom = 1.0 + 0.005 * np.sin(2 * np.pi * t / 131.0)
        M = cv2.getRotationMatrix2D((W / 2, H / 2), ang, zoom)
        M[:, 2] += (dx, dy)
        yield t, cv2.warpAffine(
            base, M, (W, H), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_REFLECT_101)


def curve_sequence(n_frames, seed=7):
    """Yield (index, frame) for a drive whose apparent lane CURVATURE
    evolves smoothly across each segment (round-4 verdict item 6).

    The plain motion_sequence jitters rigid pose, so within a segment the
    fitted lane polynomial is near-constant; this generator additionally
    bends the image with a time-varying quadratic horizontal shear

        x' = x + a(t) * ((y - y_h) / (H - y_h))**2      (y below y_h)

    which curves both lane lines like road curvature building and
    releasing: a(t) sweeps +-22 px over a ~500-frame period (plus a
    faster +-6 px harmonic), so the quadratic coefficient the reference
    fits drifts continuously for hundreds of frames — the regime where
    band-search momentum/bandwidth interplay earns its keep
    (lane_tracker.py:380-381, 474-489).  Rigid jitter and black dropouts
    from motion_sequence's recipe are kept on top.
    """
    import cv2
    from PIL import Image

    bases = [
        np.asarray(Image.open(f"assets/{n}").convert("RGB"))
        for n in ("frame911.jpg", "frame971.jpg", "test4.jpg")
    ]
    H, W = bases[0].shape[:2]
    y_h = 400.0  # bend only below the horizon band the warp samples
    seg = 150
    dropouts = {(3, k) for k in range(6)} | {(6, k) for k in range(3)}
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    bend = np.where(yy > y_h, ((yy - y_h) / (H - y_h)) ** 2, 0.0).astype(
        np.float32)
    for t in range(n_frames):
        s, k = divmod(t, seg)
        if (s, k) in dropouts:
            yield t, np.zeros_like(bases[0])
            continue
        base = bases[s % len(bases)]
        a = 22.0 * np.sin(2 * np.pi * t / 503.0) + 6.0 * np.sin(
            2 * np.pi * t / 89.0)
        dx = 4.0 * np.sin(2 * np.pi * t / 173.0)
        dy = 2.0 * np.sin(2 * np.pi * t / 97.0)
        map_x = xx + np.float32(a) * bend + np.float32(dx)
        map_y = yy + np.float32(dy)
        yield t, cv2.remap(
            base, map_x, map_y, interpolation=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_REFLECT_101)


def main(n_frames=1200, chunk=50, sequence=motion_sequence):
    import importlib.util

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
        "ref_lane_tracker_motion", "/root/reference/lane_tracker.py")
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
    ref_valid, ref_detected, ref_quad = [], [], []
    with _numpy_2017_shims():
        for t, frame in sequence(n_frames):
            ref.process(np.copy(frame), **DEMO1_KW)
            ref_valid.append(bool(ref.valid_lane_lines))
            ref_detected.append(bool(ref.detected_pixels))
            if ref_valid[-1]:
                ref_quad.append(float(ref.last_left_coeffs[0]))
            if t % 100 == 99:
                print(f"  ref {t + 1}/{n_frames}", flush=True)
    ref_ratio = tuple(ref.get_success_ratio()[1:])

    print("repo side (chunked fast pipeline, CPU backend) ...", flush=True)
    jt = _make_jax_tracker(calib, validity=PRESETS["demo1"].validity,
                            pipeline="fast")
    my_valid, my_detected = [], []
    buf = []
    import time

    t0 = time.time()
    for t, frame in sequence(n_frames):
        buf.append(frame)
        if len(buf) == chunk or t == n_frames - 1:
            outs = jt.process_chunk(np.stack(buf), with_overlay=False,
                                     **DEMO1_KW)
            my_valid.extend(bool(v) for v in np.asarray(outs.valid))
            my_detected.extend(bool(v) for v in np.asarray(outs.detected))
            buf = []
            print(f"  repo {t + 1}/{n_frames} "
                  f"({(t + 1) / (time.time() - t0):.2f} fps)", flush=True)
    my_ratio = tuple(int(v) for v in jt.get_success_ratio()[1:])

    vm = [i for i, (a, b) in enumerate(zip(my_valid, ref_valid)) if a != b]
    dm = [i for i, (a, b) in enumerate(zip(my_detected, ref_detected))
          if a != b]
    band_frames = sum(1 for i in range(1, n_frames)
                      if ref_valid[i] and ref_valid[i - 1])
    print(json.dumps({
        "n_frames": n_frames,
        "ref_success": ref_ratio,
        "repo_success": my_ratio,
        "valid_trace_mismatches": vm[:20],
        "detected_trace_mismatches": dm[:20],
        "n_valid_mismatch": len(vm),
        "n_detected_mismatch": len(dm),
        "warm_band_frames": band_frames,
        # Coefficient drift across the run — the evolving-curvature runs
        # must show the fitted quadratic actually sweeping (the regime
        # the rigid-jitter runs could not reach).
        "ref_quad_coeff_min": (round(min(ref_quad), 6) if ref_quad
                               else None),
        "ref_quad_coeff_max": (round(max(ref_quad), 6) if ref_quad
                               else None),
    }), flush=True)
    assert not vm and not dm and my_ratio == ref_ratio, "trace mismatch"
    print("continuous-motion parity: EXACT", flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]]
    seq = curve_sequence if "--curve" in args else motion_sequence
    args = [a for a in args if a != "--curve"]
    main(int(args[0]) if args else 1200, sequence=seq)
