"""Fleet-mode throughput on one device: S concurrent streams, two-phase
conditional second attempt.

The two-phase design scans attempt-1 only and pays ONE device-level
batched fallback when some local frame failed (a scanned second-attempt
lax.cond would become an executed-both-sides O(H*W) re-filter under
vmap).  This bench measures the steady state AND the failure-bearing
regimes:

  all_valid     every frame tracks; the conditional fallback never fires
  fail16        every 16th frame of ONE stream blacked — the cheapest
                failure still poisons the device's whole local batch
  fail16_all    every 16th frame of EVERY stream blacked
  dead_stream   one stream fully black (a dead camera), others valid

Each config runs under both second-attempt schedules ('two_phase' and
the unconditional 'hoist') so the crossover is measured, not reasoned
about.  Results print as one JSON line per (config, schedule) and are
appended to FLEET_BENCH.json at the repo root.

Usage: nohup python scripts/fleet_bench.py [S T ...] > /tmp/fleet.log &
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
    from lane_tracker_tpu.tracker.config import PRESETS
    from lane_tracker_tpu.tracker.step import TrackerParams, make_initial_state
    from lane_tracker_tpu.utils.timing import device_time_per_iter

    import os

    pipeline = os.environ.get("FLEET_PIPELINE", "fast")
    cam, warp = load_calibration_npz("assets/calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline=pipeline,
    )
    config = PRESETS["demo1"]

    names = ["frame911.jpg", "frame971.jpg", "test4.jpg", "straight_lines1.jpg"]
    imgs = [np.asarray(Image.open(f"assets/{n}").convert("RGB")) for n in names]

    configs = [(8, 32)]
    if argv:
        configs = [(int(argv[i]), int(argv[i + 1]))
                   for i in range(0, len(argv), 2)]

    from jax.sharding import Mesh

    from lane_tracker_tpu.parallel.streams import build_fleet_processor

    mesh = Mesh(np.asarray(jax.devices()[:1]), axis_names=("stream",))
    results = []

    for S, T in configs:
        base = np.stack([
            np.stack([imgs[(s + i) % len(imgs)] for i in range(T)])
            for s in range(S)
        ])
        variants = {"all_valid": base}
        f16 = base.copy()
        f16[0, ::16] = 0
        variants["fail16"] = f16
        f16a = base.copy()
        f16a[:, ::16] = 0
        variants["fail16_all"] = f16a
        dead = base.copy()
        dead[0] = 0
        variants["dead_stream"] = dead

        # FLEET_SCHEDULES / FLEET_LOADS trim the grid (comma-separated)
        # for time-boxed runs; the full 3x4 grid remains the default.
        schedules = tuple(
            s for s in ("two_phase", "hoist", "auto")
            if s in os.environ.get("FLEET_SCHEDULES",
                                   "two_phase,hoist,auto").split(","))
        sel_loads = os.environ.get(
            "FLEET_LOADS", ",".join(variants)).split(",")
        variants = {k: v for k, v in variants.items() if k in sel_loads}
        for schedule in schedules:
            for vname, frames in variants.items():
                resolved = schedule
                if schedule == "auto":
                    # Let the EMA controller observe the load and settle
                    # (round-4 verdict item 5), then time the schedule it
                    # resolved to: the controller only acts between
                    # chunks, so steady-state throughput IS the resolved
                    # static schedule's — the measured row proves the
                    # resolution matches the better static choice.
                    from lane_tracker_tpu.parallel.streams import StreamFleet

                    auto_fleet = StreamFleet(
                        config=config, params=params, n_streams=S,
                        mesh=mesh, with_overlay=True,
                        second_attempt="auto")
                    for _ in range(8):  # EMA(0.25): 1-(0.75)^8 = 0.90 > 0.81
                        auto_fleet.step(frames)
                    resolved = auto_fleet.schedule
                fleet = build_fleet_processor(config, mesh,
                                              with_overlay=True,
                                              second_attempt=resolved)
                frames_d = jax.device_put(frames)
                single = make_initial_state(config, params.warped_size)
                states0 = jax.tree_util.tree_map(
                    lambda x: jnp.broadcast_to(x[None], (S, *x.shape)),
                    single)

                def body(c, p):
                    states, fr = c
                    states, outs, metrics = fleet(states, fr, p)
                    d = (outs.overlay.max() & 1).astype(jnp.uint8)
                    return (states, fr ^ d)

                # One eager call for the valid fraction the load produces.
                _, outs0, metrics0 = fleet(states0, frames_d, params)
                vf = float(np.asarray(metrics0["valid_frames"])
                           / np.asarray(metrics0["frames"]))

                per_iter, _ = device_time_per_iter(
                    lambda: (states0, frames_d), body, n_iters=8, repeats=3,
                    invariant=params)
                frames_per_call = S * T
                fps = frames_per_call / per_iter
                rec = {
                    "streams": S, "chunk": T,
                    "schedule": schedule, "load": vname,
                    **({"resolved_schedule": resolved}
                       if schedule == "auto" else {}),
                    "aggregate_fps": round(fps, 1),
                    "ms_per_frame": round(per_iter / frames_per_call * 1e3,
                                          3),
                    "valid_fraction": round(vf, 4),
                    **({"pipeline": pipeline} if pipeline != "fast" else {}),
                }
                results.append(rec)
                print(json.dumps(rec), flush=True)

    # The 'fast' sweep IS the artifact; non-default pipelines append so
    # the committed fast rows are never clobbered by a variant run, and a
    # fast rewrite carries forward the existing variant rows PLUS fast
    # rows for (streams, chunk) configs this run did not re-measure.
    kept = []
    if pipeline == "fast":
        ran = {(S, T) for S, T in configs}
        try:
            with open("FLEET_BENCH.json") as f:
                kept = [
                    ln for ln in f
                    if json.loads(ln).get("pipeline")
                    or (json.loads(ln)["streams"],
                        json.loads(ln)["chunk"]) not in ran
                ]
        except FileNotFoundError:
            pass
    mode = "w" if pipeline == "fast" else "a"
    with open("FLEET_BENCH.json", mode) as f:
        for rec in results:
            f.write(json.dumps(rec) + "\n")
        for ln in kept:
            f.write(ln)
    print("wrote FLEET_BENCH.json", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
