"""Headline benchmark: end-to-end process() frames/sec on one GPU.

Measures the chunked single-stream pipeline (vmapped front half + scanned
tracker + vmapped overlay rendering) on real 1280x720 dashcam frames with
the full demo1 parameter set — the same work the reference's
``LaneTracker.process`` does per frame (undistort, warp, LAB, tophat,
bilateral threshold, noise mask, search, fit, validity, smoothing, radius,
eccentricity, overlay), measured steady-state with frames resident on the
device,
in 512-frame chunks by default (BENCH_T overrides).

The default configuration is the CERTIFIED-corridor serving pipeline:
compute is restricted to the decision corridor + its filter-influence
margin, and the run hard-asserts every frame's corridor_ok certificate
(reads stayed interior => decision trace bit-identical to the full-width
'fast' chain) on top of the oracle trace/rmse gate.  BENCH_PIPELINE=fast
measures the full-width exact chain.

Baseline: the reference measures 153.8 ms/frame (6.5 fps) on CPU
(BASELINE.md).  Needs a GPU: without one it exits before measuring.
Prints ONE JSON line, naming the device and the card's power limit.
"""

import json
import sys

import numpy as np

sys.path.insert(0, ".")

REFERENCE_FPS = 6.5  # measured reference steady state (BASELINE.md)


def _corridor_fallback(n_bad: int):
    """A tripped corridor certificate on the DEFAULT configuration falls
    back to the full-width exact chain instead of dying.

    The certificate hard-gates the corridor headline's exactness claim:
    if this content ever escapes the corridor (certificate False on some
    frames), the default run measures the slower-but-exact 'fast' chain
    instead of reporting nothing.  An EXPLICIT BENCH_PIPELINE=corridor
    request still asserts, so the certificate remains testable.
    """
    import os

    msg = f"corridor certificate failed on {n_bad} frames"
    if os.environ.get("BENCH_PIPELINE") is not None:
        raise AssertionError(msg)
    print(f"{msg}; falling back to the full-width 'fast' pipeline",
          file=sys.stderr)
    os.environ["BENCH_PIPELINE"] = "fast"
    os.execv(sys.executable, [sys.executable] + sys.argv)


def main():
    import jax

    from lane_tracker_tpu.utils.card import (
        card_name_and_power_limit,
        device_summary,
        require_gpu,
    )
    from lane_tracker_tpu.utils.compile_cache import setup_compile_cache

    require_gpu()
    card = card_name_and_power_limit()
    setup_compile_cache()

    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.parallel.pipeline import build_chunk_processor
    from lane_tracker_tpu.tracker.config import PRESETS
    from lane_tracker_tpu.tracker.step import TrackerParams, make_initial_state

    cam, warp = load_calibration_npz("assets/calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix,
        cam.dist_coeffs,
        warp.M,
        warp.Minv,
        warp.image_width_height,
        warp.warped_width_height,
        warp.mppv,
        warp.mpph,
        # Default: the CERTIFIED-corridor serving configuration — the
        # warp/LAB/filter compute the decision corridor + its influence
        # margin, and every frame carries a corridor_ok certificate
        # proving its decision trace is bit-identical to the full-width
        # 'fast' chain (tracker/step._run_attempt).  This run hard-asserts
        # the certificate on ALL frames plus the usual oracle trace/rmse
        # gate, so the headline is exact-output-certified, not
        # approximate.  BENCH_PIPELINE=fast measures the full-width
        # exact chain.
        pipeline=__import__("os").environ.get("BENCH_PIPELINE", "corridor"),
    )
    config = PRESETS["demo1"]

    # Frames per chunk (throughput mode; latency-sensitive serving would
    # use smaller chunks).
    T = int(__import__("os").environ.get("BENCH_T", "512"))
    # BENCH_FAIL_EVERY=k blacks out every k-th frame so the chunk bears
    # detection failures and the two-phase second attempt actually FIRES —
    # bounding the fallback's cost honestly (the default all-valid chunk
    # measures the steady state, where the conditional fallback is free).
    # BENCH_MOTION=1 runs the continuous-motion generator's frames instead
    # of the 4-still cycle, so the headline is also earned on content
    # where every frame is unique and band search tracks real motion.
    fail_every = int(__import__("os").environ.get("BENCH_FAIL_EVERY", "0"))
    motion = bool(int(__import__("os").environ.get("BENCH_MOTION", "0")))
    if motion:
        from scripts.motion_longrun import motion_sequence

        chunk = np.stack([f for _, f in motion_sequence(T)])
    else:
        # The four stills, PIL-decoded as the oracles were
        # (scripts/make_stills.py).
        imgs = np.load("assets/stills.npz")["frames"]
        chunk = np.stack([imgs[i % len(imgs)] for i in range(T)])
        if fail_every:
            chunk[::fail_every] = 0
    chunk_d = jax.device_put(chunk)

    # two_phase: attempt-1-only scan with ONE chunk-level conditional
    # batched fallback — the steady-state-optimal schedule (see
    # parallel/pipeline.py; bit-exact vs the per-frame cond).
    step = build_chunk_processor(config, with_overlay=True,
                                 second_attempt="two_phase")
    state = make_initial_state(config, params.warped_size)

    # Correctness/sanity pass (also compiles the single-chunk program).
    state, outs = step(state, chunk_d, params)
    _ = np.asarray(outs.valid)

    # Corridor exactness certificate: all frames' search reads stayed
    # inside the corridor => decision traces are bit-identical to 'fast'
    # (tracker/step._run_attempt).  Certified runs then hold the same
    # hard trace gate as the exact pipelines below.
    cert_frac = None
    certified = True
    if params.pipeline == "corridor":
        cert = np.asarray(outs.corridor_ok)
        cert_frac = float(cert.mean())
        certified = bool(cert.all())
        if not certified:
            _corridor_fallback(int((~cert).sum()))

    # Quality gate: coefficient-curve RMSE vs the live reference's trace
    # over this exact sequence (assets/bench_oracle*.npz, generated by
    # scripts/make_bench_oracle.py — one oracle per bench variant, so the
    # fail-bearing and motion runs are quality-gated too).  The north
    # star couples throughput with <0.5 px RMSE (BASELINE.json), so the
    # bench artifact reports both.  Compared on the first chunk from a
    # fresh state — the same trajectory the oracle ran.
    rmse_max = rmse_mean = None
    n_gate = n_valid_mismatch = 0
    oracle_name = ("assets/bench_oracle_motion.npz" if motion
                   else f"assets/bench_oracle_fail{fail_every}.npz"
                   if fail_every else "assets/bench_oracle.npz")
    try:
        oracle = np.load(oracle_name)
        # Gate on the oracle-covered prefix (the default oracles cover the
        # full 512-frame default chunk; regenerate with
        # scripts/make_bench_oracle.py for larger T).
        n_gate = min(T, len(oracle["valid"]))
        ov, ol, orr = (oracle["valid"][:n_gate], oracle["left"][:n_gate],
                       oracle["right"][:n_gate])
        mv = np.asarray(outs.valid)[:n_gate]
        if params.pipeline in ("turbo", "half") or not certified:
            # Explicitly-approximate (uncertified) pipelines: decision
            # divergence is reported data, not an error (the exact and
            # certified-corridor pipelines hard-assert below).
            n_valid_mismatch = int((mv != ov).sum())
        else:
            assert (mv == ov).all(), "validity trace diverges from reference"
        yy = np.arange(int(params.warped_size[1]), dtype=float)
        rs = []
        for t in range(n_gate):
            if not (ov[t] and mv[t]):
                continue
            for mine, ref in (
                (np.asarray(outs.left_coeffs[t], float), ol[t]),
                (np.asarray(outs.right_coeffs[t], float), orr[t]),
            ):
                rs.append(np.sqrt(np.mean(
                    (np.polyval(mine, yy) - np.polyval(ref, yy)) ** 2)))
        rmse_max = float(np.max(rs))
        rmse_mean = float(np.mean(rs))
    except FileNotFoundError:
        pass

    # Device throughput: chain chunks inside ONE jitted program with a
    # data dependency, so the host's dispatch and fetch drop out of the
    # per-chunk time (utils/timing.py).
    from lane_tracker_tpu.utils.timing import device_time_per_iter

    def make_carry():
        return (state, chunk_d)

    def body(carry, p):
        st, ch = carry
        st, outs = step_fn(st, ch, p)
        dep = (jnp.max(outs.overlay) & 1).astype(jnp.uint8)
        return (st, ch ^ dep)

    import jax.numpy as jnp

    from lane_tracker_tpu.parallel.pipeline import chunk_process

    def step_fn(st, ch, p):
        return chunk_process(st, ch, p, config, True,
                             second_attempt="two_phase")

    per_chunk, _rtt = device_time_per_iter(
        make_carry, body, n_iters=16, invariant=params)
    fps = T / per_chunk

    # Sanity: the tracker must actually be tracking on these frames.
    valid_frac = float(np.asarray(outs.valid).mean())

    line = json.dumps(
            {
                "metric": "1280x720 frames/sec/device end-to-end process()",
                "value": round(fps, 1),
                "unit": "frames/s",
                "vs_baseline": round(fps / REFERENCE_FPS, 1),
                "chunk_size": T,
                "valid_fraction": round(valid_frac, 3),
                "rmse_px_max": (round(rmse_max, 4)
                                if rmse_max is not None else None),
                "rmse_px_mean": (round(rmse_mean, 4)
                                 if rmse_mean is not None else None),
                "rmse_gate_frames": (None if rmse_max is None
                                     else int(n_gate)),
                "bench_variant": ("motion" if motion
                                  else f"fail{fail_every}" if fail_every
                                  else "stills"),
                **({"pipeline": params.pipeline,
                    "valid_mismatch_frames": n_valid_mismatch}
                   if params.pipeline != "fast" else {}),
                **({"corridor_ok_fraction": cert_frac,
                    "certified_exact": certified}
                   if params.pipeline == "corridor" else {}),
                "device": device_summary(),
                "card": card,
            }
        )
    print(line)


if __name__ == "__main__":
    main()
