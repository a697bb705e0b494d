"""Diagnose the motion-bench RMSE outlier (round 4).

The BENCH_MOTION=1 run gated 512 frames against the live reference's
trace: validity decisions bit-identical, rmse_px_mean 0.0026 — but
rmse_px_max 0.7572 on a single frame (t=8).  This script decomposes
that frame against the live reference, hypothesis by hypothesis:

  python scripts/motion_rmse_diag.py [T]
    Rank frames by curve RMSE vs the oracle, then capture the
    reference's exact np.polyfit input pixels on the worst frame and
    refit them with our f32 row-moment solver.  MEASURED: same-pixels
    f32 vs f64 fit = 2e-5 px — fit arithmetic is exonerated.

  python scripts/motion_rmse_diag.py --pixset [t]
    Diff OUR pipeline's fit pixel set against the reference's captured
    one and attribute the RMSE.  MEASURED: our band edges match the
    reference's integer-for-integer; the divergence is 17 missing
    white pixels (rows 878-879) whose f64 refit reproduces the 0.7572
    exactly — caused by a single documented ±1-intensity-unit
    float-path warp deviation 27 px away (50 R + 34 LAB-B such pixels
    frame-wide, 0.004%, all |d|=1), inside the tophat/threshold reach
    of the flipped cluster.
"""

import sys

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", "tests/.jax_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def main(T=512):
    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.parallel.pipeline import build_chunk_processor
    from lane_tracker_tpu.tracker.config import PRESETS
    from lane_tracker_tpu.tracker.step import (TrackerParams,
                                               make_initial_state)
    from scripts.motion_longrun import motion_sequence

    cam, warp = load_calibration_npz("assets/calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="fast")
    config = PRESETS["demo1"]

    chunk = np.stack([f for _, f in motion_sequence(T)])
    step = build_chunk_processor(config, with_overlay=False,
                                 second_attempt="two_phase")
    state = make_initial_state(config, params.warped_size)
    state, outs = step(state, jax.device_put(chunk), params)

    oracle = np.load("assets/bench_oracle_motion.npz")
    ov = oracle["valid"][:T]
    mv = np.asarray(outs.valid)[:T]
    assert (mv == ov).all(), "validity trace diverges"

    yy = np.arange(int(params.warped_size[1]), dtype=float)
    per_frame = np.zeros(T)
    side = np.empty(T, dtype="U5")
    for t in range(T):
        if not ov[t]:
            continue
        for name, mine, ref in (
            ("left", np.asarray(outs.left_coeffs[t], float),
             oracle["left"][t]),
            ("right", np.asarray(outs.right_coeffs[t], float),
             oracle["right"][t]),
        ):
            r = float(np.sqrt(np.mean(
                (np.polyval(mine, yy) - np.polyval(ref, yy)) ** 2)))
            if r > per_frame[t]:
                per_frame[t], side[t] = r, name
    order = np.argsort(per_frame)[::-1]
    print("worst frames (t, side, rmse_px, valid-run context):")
    for t in order[:8]:
        # distance since the last invalid frame (fresh-track frames have
        # the thinnest pixel support)
        back = 0
        while t - 1 - back >= 0 and ov[t - 1 - back]:
            back += 1
        print(f"  t={t:3d} {side[t]:>5} rmse={per_frame[t]:.4f} "
              f"valid_run_len={back}")
    print(f"frames > 0.5 px: {int((per_frame > 0.5).sum())}; "
          f"> 0.1 px: {int((per_frame > 0.1).sum())}")

    # Coefficient-roundtrip probe (kept for the record: it measures ZERO,
    # refuting the "storage precision" hypothesis — the cause must be in
    # the fit itself).
    t = int(order[0])
    for name in ("left", "right"):
        ref = oracle[name][t]
        ys = yy[:: max(1, len(yy) // 64)]
        vals32 = np.polyval(ref, ys).astype(np.float32).astype(float)
        refit = np.polyfit(ys, vals32, 2)
        r = float(np.sqrt(np.mean(
            (np.polyval(refit, yy) - np.polyval(ref, yy)) ** 2)))
        print(f"t={t} {name}: f32-roundtrip refit rmse={r:.5f} px")

    # Decisive probe: capture the reference's EXACT fit inputs (the pixel
    # coordinate lists np.polyfit sees) on the worst frame, then refit
    # those same pixels with our float32 row-moment solver
    # (ops/polyfit.fit_poly_rows).  The curve RMSE between the two fits of
    # the SAME pixel set isolates fit arithmetic from pixel-set
    # divergence.
    capture_ref_fit_inputs(t, yy, oracle)


def _ref_fit_inputs(t_target, oracle):
    """Run the reference over motion frames 0..t_target and capture the
    exact (y, x) pixel lists its np.polyfit sees on frame t_target."""
    import importlib.util

    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.tracker.config import PRESETS
    from scripts.make_bench_oracle import bench_frames
    from tests.test_corpus import _patch_validity
    from tests.test_longrun import _cache_ref_filter
    from tests.test_tracker import (DEMO1_KW, _band_patch, _make_ref_tracker,
                                    _numpy_2017_shims)

    spec = importlib.util.spec_from_file_location(
        "ref_lane_tracker_diag", "/root/reference/lane_tracker.py")
    sys.path.insert(0, "/root/reference")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class M:
        LaneTracker = mod.LaneTracker

    calib = load_calibration_npz("assets/calibration.npz")
    ref = _make_ref_tracker(M, calib)
    _band_patch(ref)
    _patch_validity(ref, PRESETS["demo1"].validity)
    _cache_ref_filter(ref)

    frames = bench_frames(t_target + 1, motion=True)
    captured = []
    warped = []
    real_polyfit = np.polyfit
    orig_filter = ref.filter_lane_points

    def recording_filter(img, **kw):
        warped.append(np.copy(img))
        return orig_filter(img, **kw)

    def recording_polyfit(x, y, deg, *a, **k):
        out = real_polyfit(x, y, deg, *a, **k)
        captured.append((np.asarray(x, float).copy(),
                         np.asarray(y, float).copy(), out.copy()))
        return out

    with _numpy_2017_shims():
        for t, frame in enumerate(frames):
            if t == t_target:
                np.polyfit = recording_polyfit
                ref.filter_lane_points = recording_filter
            try:
                ref.process(np.copy(frame), **DEMO1_KW)
            finally:
                np.polyfit = real_polyfit
                ref.filter_lane_points = orig_filter

    sets = {}
    for name in ("left", "right"):
        want = oracle[name][t_target]
        hits = [(ys, xs) for ys, xs, out in captured
                if out.shape == (3,) and np.allclose(out, want)]
        sets[name] = hits[0] if hits else None
    sets["warped"] = warped[0] if warped else None
    return sets


def capture_ref_fit_inputs(t_target, yy, oracle):
    from lane_tracker_tpu.ops.polyfit import fit_poly_rows

    sets = _ref_fit_inputs(t_target, oracle)
    W = 1080
    for name in ("left", "right"):
        want = oracle[name][t_target]
        if sets[name] is None:
            print(f"t={t_target} {name}: fit-input capture missed")
            continue
        ys, xs = sets[name]
        H = int(np.ceil(yy[-1])) + 1
        row_n = np.zeros(H)
        row_sx = np.zeros(H)
        np.add.at(row_n, ys.astype(int), 1.0)
        np.add.at(row_sx, ys.astype(int), xs)
        ours = np.asarray(
            fit_poly_rows(jnp_f32(row_n), jnp_f32(row_sx), W), float)
        r_ours = curve_rmse(ours, want, yy)
        # Same moments solved in float64 (the arithmetic-free control).
        f64 = np.polyfit(ys, xs, 2)
        r_f64 = curve_rmse(f64, want, yy)
        span = (int(ys.min()), int(ys.max()))
        print(f"t={t_target} {name}: n_px={len(ys)} y_span={span} "
              f"rows={int((row_n > 0).sum())}")
        print(f"  same-pixels f64 np.polyfit rmse: {r_f64:.5f} px")
        print(f"  same-pixels f32 fit_poly_rows rmse: {r_ours:.5f} px")


def pixset_probe(t_target=8):
    """Diff OUR pipeline's fit pixel set on frame t_target against the
    reference's captured one, and attribute the curve RMSE to it.

    The same-pixels probe above shows fit arithmetic contributes ~2e-5 px;
    this one isolates the remaining cause — band-interval edge
    quantization (ops/search.band_intervals floor/ceil on the previous
    raw fit, whose own f32 noise is ~1e-5 px) admitting/dropping boundary
    pixels.
    """
    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.ops.search import band_intervals
    from lane_tracker_tpu.parallel.pipeline import build_chunk_processor
    from lane_tracker_tpu.tracker.config import PRESETS
    from lane_tracker_tpu.tracker.step import (TrackerParams, front_half,
                                               make_initial_state)
    from scripts.motion_longrun import motion_sequence

    cam, warp = load_calibration_npz("assets/calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline="fast")
    config = PRESETS["demo1"]
    W, H = params.warped_size

    oracle = np.load("assets/bench_oracle_motion.npz")
    frames = np.stack([f for _, f in motion_sequence(t_target + 1)])

    # Our state after frames 0..t_target-1, then this frame's binary.
    step = build_chunk_processor(config, with_overlay=False,
                                 second_attempt="two_phase")
    state0 = make_initial_state(config, params.warped_size)
    state, outs = step(state0, jax.device_put(frames[:t_target]), params)
    r_chan, b_chan, binary = front_half(jax.device_put(frames[t_target]),
                                        params, config)
    binary = np.asarray(binary)
    iv = band_intervals(state.last_left, state.last_right, config.search,
                        H, W)
    ref_sets = _ref_fit_inputs(t_target, oracle)
    yy = np.arange(H, dtype=float)

    print(f"prev-fit delta (ours vs oracle t={t_target - 1}): "
          f"left={np.abs(np.asarray(state.last_left) - oracle['left'][t_target - 1])}, "
          f"right={np.abs(np.asarray(state.last_right) - oracle['right'][t_target - 1])}")
    for name, lo, hi in (("left", iv.left_lo, iv.left_hi),
                         ("right", iv.right_lo, iv.right_hi)):
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        ok = np.asarray(iv.left_valid if name == "left" else iv.right_valid)
        ys_all, xs_all = np.nonzero(binary)
        keep = ok[ys_all] & (xs_all >= lo[ys_all]) & (xs_all < hi[ys_all])
        mine = set(zip(ys_all[keep].tolist(), xs_all[keep].tolist()))
        rys, rxs = ref_sets[name]
        theirs = set(zip(rys.astype(int).tolist(), rxs.astype(int).tolist()))
        extra = sorted(mine - theirs)
        missing = sorted(theirs - mine)
        print(f"{name}: ours={len(mine)} ref={len(theirs)} "
              f"extra={len(extra)} missing={len(missing)}")
        for tag, px in (("extra", extra[:6]), ("missing", missing[:6])):
            if px:
                print(f"  {tag}: {px}")
        # Attribution: f64 fit of OUR set vs the oracle coefficients.
        if mine:
            ys = np.array([p[0] for p in mine], float)
            xs = np.array([p[1] for p in mine], float)
            r = curve_rmse(np.polyfit(ys, xs, 2), oracle[name][t_target], yy)
            print(f"  f64 fit of OUR set vs oracle: rmse={r:.4f} px "
                  f"(the set difference IS the outlier if this ~= the "
                  f"measured per-frame rmse)")

    # Stage attribution: diff our warped channels against the reference's
    # captured warped frame (the filter's input) — global counts plus the
    # neighborhood of the set difference.
    ref_warped = ref_sets.get("warped")
    if ref_warped is not None:
        import cv2

        our_r = np.asarray(r_chan, np.int32)
        our_b = np.asarray(b_chan, np.int32)
        ref_r = ref_warped[:, :, 0].astype(np.int32)
        ref_b = cv2.cvtColor(ref_warped, cv2.COLOR_RGB2LAB)[:, :, 2].astype(
            np.int32)
        for nm, ours, refs in (("R", our_r, ref_r), ("LAB-B", our_b, ref_b)):
            d = ours - refs
            nz = int((d != 0).sum())
            print(f"warped {nm}: {nz} px differ "
                  f"({100.0 * nz / d.size:.4f}%), max |d| = "
                  f"{int(np.abs(d).max())}")
            if nz:
                ys_d, xs_d = np.nonzero(d)
                # Distance from the flipped binary cluster: the filter's
                # influence reach is tophat (k<=55) + threshold (k<=65)
                # windows, ~60 px in each axis.
                dist = np.maximum(np.abs(ys_d - 879), np.abs(xs_d - 445))
                k = np.argsort(dist)[:6]
                print(f"  nearest to the flipped cluster (879,445): "
                      f"{[(int(ys_d[i]), int(xs_d[i]), int(d[ys_d[i], xs_d[i]]), int(dist[i])) for i in k]}")


def curve_rmse(a, b, yy):
    return float(np.sqrt(np.mean(
        (np.polyval(a, yy) - np.polyval(b, yy)) ** 2)))


def jnp_f32(a):
    import jax.numpy as jnp

    return jnp.asarray(a, jnp.float32)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--pixset":
        pixset_probe(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 512)
