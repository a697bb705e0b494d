"""Per-stage device timing of the chunked pipeline.

Breaks the end-to-end budget (bench.py) into named stages, each timed with
the chained-iteration protocol from utils/timing.py (so the host's dispatch
and fetch drop out).  Prints one JSON line per stage.

Usage:  nohup python scripts/stage_bench.py [stage ...] > /tmp/stages.log &
        (no args = all stages)
"""

import json
import sys

import numpy as np

sys.path.insert(0, ".")

import os
T = int(os.environ.get("STAGE_T", "128"))
PIPELINE = os.environ.get("STAGE_PIPELINE", "fast")


def main(selected):
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.ops.color import rgb2lab_b_fast
    from lane_tracker_tpu.ops.filters import filter_lane_points_channels
    from lane_tracker_tpu.ops.integrals import build_row_prefixes
    from lane_tracker_tpu.ops.morphology import tophat_ellipse
    from lane_tracker_tpu.ops.search import sws_precompute
    from lane_tracker_tpu.ops.threshold import bilateral_adaptive_threshold
    from lane_tracker_tpu.kernels.resample import bilinear_gather_pair
    from lane_tracker_tpu.parallel.pipeline import chunk_process
    from lane_tracker_tpu.tracker.config import PRESETS
    from lane_tracker_tpu.tracker.step import (
        TrackerParams,
        back_half,
        front_artifacts_batch,
        make_initial_state,
        render_frame,
    )
    from lane_tracker_tpu.utils.timing import device_time_per_iter

    cam, warp = load_calibration_npz("assets/calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline=PIPELINE,
    )
    config = PRESETS["demo1"]
    f1 = config.filter

    names = ["frame911.jpg", "frame971.jpg", "test4.jpg", "straight_lines1.jpg"]
    imgs = [np.asarray(Image.open(f"assets/{n}").convert("RGB")) for n in names]
    chunk = np.stack([imgs[i % len(imgs)] for i in range(T)])
    chunk_d = jax.device_put(chunk)

    Wc, Hc = params.img_size
    Ww, Hw = params.warped_size

    # Precomputed stage inputs (device).
    from lane_tracker_tpu.tracker.step import _warp_channels

    def filter1(r, b):
        return jax.vmap(lambda rr, bb: filter_lane_points_channels(
            rr, bb, filter_type=f1.filter_type, ksize_r=f1.ksize_r,
            C_r=f1.C_r, ksize_b=f1.ksize_b, C_b=f1.C_b,
            mask_noise=f1.mask_noise, ksize_noise=f1.ksize_noise,
            C_noise=f1.C_noise, noise_thresh=f1.noise_thresh))(r, b)

    @jax.jit
    def prep(frames, p):
        r, b = jax.vmap(lambda f: _warp_channels(f, p))(frames)
        return r, b, filter1(r, b)

    r_ch, b_ch, bin1 = jax.block_until_ready(prep(chunk_d, params))

    def dep_u8(x):
        return (jnp.max(x) & 1).astype(jnp.uint8)

    stages = {}

    # --- LAB on raw frames ---
    def lab_body(c, p):
        out = jax.vmap(rgb2lab_b_fast)(c)
        return c ^ dep_u8(out)
    stages["lab_fast"] = (lambda: chunk_d, lab_body)

    # --- warp pair gather (both channels) ---
    def warp_body(c, p):
        rr, bb = jax.vmap(lambda f: _warp_channels(f, p))(c)
        d = dep_u8(rr) ^ dep_u8(bb)
        return c ^ d
    stages["warp_pair"] = (lambda: chunk_d, warp_body)

    # --- filter stage (attempt 1, full) ---
    def filt_body(c, p):
        r, b = c
        d = dep_u8(filter1(r, b))
        return (r ^ d, b ^ d)
    stages["filter_full"] = (lambda: (r_ch, b_ch), filt_body)

    # --- filter sub-stages ---
    def tophat_r_body(c, p):
        out = jax.vmap(lambda x: tophat_ellipse(x, 29))(c)
        return c ^ dep_u8(out)
    stages["tophat29_r"] = (lambda: r_ch, tophat_r_body)

    def tophat_b_body(c, p):
        out = jax.vmap(lambda x: tophat_ellipse(x, 55))(c)
        return c ^ dep_u8(out)
    stages["tophat55_b"] = (lambda: b_ch, tophat_b_body)

    def bilat_body(c, p):
        out = jax.vmap(lambda x: bilateral_adaptive_threshold(
            x, ksize=f1.ksize_r, C=f1.C_r))(c)
        return c ^ dep_u8(out)
    stages["bilateral_r"] = (lambda: r_ch, bilat_body)

    def bilat35_body(c, p):
        out = jax.vmap(lambda x: bilateral_adaptive_threshold(
            x, ksize=f1.ksize_b, C=f1.C_b))(c)
        return c ^ dep_u8(out)
    stages["bilateral_b35"] = (lambda: b_ch, bilat35_body)

    def bilat65_body(c, p):
        out = jax.vmap(lambda x: bilateral_adaptive_threshold(
            x, ksize=f1.ksize_noise, C=f1.C_noise))(c)
        return c ^ dep_u8(out)
    stages["bilateral_noise65"] = (lambda: b_ch, bilat65_body)

    from lane_tracker_tpu.ops.morphology import open_ellipse

    def open_body(c, p):
        out = jax.vmap(lambda x: open_ellipse(x, 5))(c)
        return c ^ dep_u8(out)
    stages["open5"] = (lambda: bin1, open_body)

    # --- prefixes + sws precompute ---
    def prefix_body(c, p):
        pref = jax.vmap(build_row_prefixes)(c)
        d = (jnp.max(pref.packed) & 1).astype(jnp.uint8)
        return c ^ d
    stages["row_prefixes"] = (lambda: bin1, prefix_body)

    def sws_body(c, p):
        s = jax.vmap(lambda x: sws_precompute(x, config.search))(c)
        leaves = jax.tree_util.tree_leaves(s)
        d = (jnp.max(leaves[0]) != 0).astype(jnp.uint8)
        return c ^ d
    stages["sws_precompute"] = (lambda: bin1, sws_body)

    # --- front half total ---
    def front_body(c, p):
        arts = front_artifacts_batch(c, p, config)
        d = (jnp.max(arts.pref.packed) & 1).astype(jnp.uint8)
        return c ^ d
    stages["front_total"] = (lambda: chunk_d, front_body)

    # --- back half scan ---
    arts0 = jax.jit(
        lambda fr, p: front_artifacts_batch(fr, p, config)
    )(chunk_d, params)
    arts0 = jax.block_until_ready(arts0)
    state0 = make_initial_state(config, params.warped_size)

    def back_body(c, p):
        st, arts = c
        def body(s, a):
            s, out, meta = back_half(s, a, p, config)
            return s, out.valid
        st2, valids = jax.lax.scan(body, st, arts)
        return (st2, arts)
    stages["back_scan"] = (lambda: (state0, arts0), back_body)

    # --- render ---
    state1, _, meta1 = jax.jit(
        lambda s, a, p: back_half(s, jax.tree_util.tree_map(lambda x: x[0], a),
                                  p, config)
    )(state0, arts0, params)
    metasT = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (T,) + x.shape), meta1)
    metasT = jax.block_until_ready(metasT)

    def render_body(c, p):
        fr, metas = c
        out = jax.vmap(lambda f, m: render_frame(f, m, p, config))(fr, metas)
        return (fr ^ dep_u8(out), metas)
    stages["render"] = (lambda: (chunk_d, metasT), render_body)

    # --- end to end (reference point) ---
    def e2e_body(c, p):
        st, ch = c
        st, outs = chunk_process(st, ch, p, config, True)
        return (st, ch ^ dep_u8(outs.overlay))
    stages["e2e"] = (lambda: (state0, chunk_d), e2e_body)

    run = selected or list(stages)
    for name in run:
        mk, body = stages[name]
        per_iter, rtt = device_time_per_iter(
            mk, body, n_iters=8, repeats=3, invariant=params)
        print(json.dumps({
            "stage": name,
            "ms_per_frame": round(per_iter / T * 1e3, 4),
            "ms_per_chunk": round(per_iter * 1e3, 2),
            "rtt_s": round(rtt, 3),
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
