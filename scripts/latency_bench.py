"""Serving latency vs throughput: the chunk-size trade, measured.

The T=512 headline chunk is a throughput configuration: a frame entering
an empty chunk waits up to T frame-arrivals for the chunk to fill plus
one chunk-compute time before its overlay exists.  Latency-sensitive
serving uses smaller chunks at some fps cost (per-chunk scan setup and
scheduling stop amortizing).  This script measures that trade: one row
per chunk size T with device throughput (utils/timing.py protocol) and
the compute component of latency (per-chunk device time — the queueing
component T/fps_source is a property of the camera rate, not the
device).

Results are written to LATENCY_BENCH.json at the repo root, one JSON
line per T.

Usage: nohup python scripts/latency_bench.py [T ...] > /tmp/latency.log &
"""

import json
import sys

import numpy as np

sys.path.insert(0, ".")


def main(argv):
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.parallel.pipeline import (
        build_chunk_processor,
        chunk_process,
    )
    from lane_tracker_tpu.tracker.config import PRESETS
    from lane_tracker_tpu.tracker.step import TrackerParams, make_initial_state
    from lane_tracker_tpu.utils.timing import device_time_per_iter

    cam, warp = load_calibration_npz("assets/calibration.npz")
    config = PRESETS["demo1"]

    names = ["frame911.jpg", "frame971.jpg", "test4.jpg",
             "straight_lines1.jpg"]
    imgs = [np.asarray(Image.open(f"assets/{n}").convert("RGB"))
            for n in names]

    sizes = [int(a) for a in argv] or [1, 2, 4, 8, 16, 64, 256, 512]
    # Both the certified-corridor serving default (bench.py's headline
    # pipeline, measured first so a mid-run outage keeps the most
    # important rows) and the full-width exact chain.
    pipelines = ("corridor", "fast")
    # Crash-safe incremental artifact: rows keyed (pipeline, chunk) merge
    # into the existing file after every measurement, so an outage mid-
    # sweep loses one row, not the run, and a restart re-measures only
    # what it is asked to.
    rows = {}
    try:
        with open("LATENCY_BENCH.json") as f:
            for ln in f:
                r = json.loads(ln)
                rows[(r.get("pipeline", "fast"), r["chunk"])] = r
    except FileNotFoundError:
        pass

    def flush():
        order = {"corridor": 0, "fast": 1}
        with open("LATENCY_BENCH.json", "w") as f:
            for k in sorted(rows, key=lambda k: (order.get(k[0], 9), k[1])):
                f.write(json.dumps(rows[k]) + "\n")

    for pipeline in pipelines:
        params = TrackerParams.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height,
            warp.mppv, warp.mpph, pipeline=pipeline,
        )
        # Small chunks opt into the row-matmul resampler (bit-identical;
        # kernels/resample_rowmm.py) — the per-pixel gather's per-index
        # cost is the measured single-frame latency cliff.
        params_mm = params.with_rowmm()
        import os

        use_rowmm = bool(int(os.environ.get("LATENCY_ROWMM", "0")))
        skip = bool(int(os.environ.get("LATENCY_SKIP_EXISTING", "1")))
        for T in sizes:
            from lane_tracker_tpu.tracker.step import _WARP_VMAP_MIN_T

            if skip and (pipeline, T) in rows and \
                    bool(rows[(pipeline, T)].get("resampler") == "rowmm") \
                    == (use_rowmm and T < _WARP_VMAP_MIN_T):
                continue
            p_run = (params_mm if use_rowmm and T < _WARP_VMAP_MIN_T
                     else params)
            chunk = np.stack([imgs[i % len(imgs)] for i in range(T)])
            chunk_d = jax.device_put(chunk)
            step = build_chunk_processor(config, with_overlay=True,
                                         second_attempt="two_phase")
            state = make_initial_state(config, params.warped_size)
            state, outs = step(state, chunk_d, p_run)  # compile + sanity
            assert bool(np.asarray(outs.valid).all()), \
                f"tracking failed at T={T}"
            if pipeline == "corridor":
                assert bool(np.asarray(outs.corridor_ok).all()), \
                    f"corridor certificate failed at T={T}"

            def body(carry, p):
                st, ch = carry
                st, outs = chunk_process(st, ch, p, config, True,
                                         second_attempt="two_phase")
                dep = (jnp.max(outs.overlay) & 1).astype(jnp.uint8)
                return (st, ch ^ dep)

            # Scale chained iterations so small-T runs accumulate enough
            # device time to dominate the fixed-cost subtraction's noise,
            # but bound the single chained call by the eager call's own
            # measured duration.
            import time as _time

            t0 = _time.perf_counter()
            _ = np.asarray(step(state, chunk_d, p_run)[1].valid)
            eager_s = max(_time.perf_counter() - t0, 1e-3)
            budget = 20.0  # seconds per chained call, well under the bar
            n_iters = int(min(512, max(8, 2048 // T),
                              max(8, budget // eager_s)))
            per_chunk, _ = device_time_per_iter(
                lambda: (state, chunk_d), body, n_iters=n_iters, repeats=3,
                invariant=p_run)
            rec = {
                "pipeline": pipeline,
                "chunk": T,
                "fps": round(T / per_chunk, 1),
                "ms_per_frame": round(per_chunk / T * 1e3, 3),
                "chunk_compute_ms": round(per_chunk * 1e3, 3),
            }
            if use_rowmm and T < _WARP_VMAP_MIN_T:
                rec["resampler"] = "rowmm"
            rows[(pipeline, T)] = rec
            flush()
            print(json.dumps(rec), flush=True)

    print("wrote LATENCY_BENCH.json", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
