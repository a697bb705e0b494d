"""Smoke test of the lane tracker on one NVIDIA GPU, at full geometry.

Drives the system's main path through the entry points a user calls —
``LaneTracker.process`` per frame, the chunked throughput processor
(``build_chunk_processor``, what ``LaneTracker.process_chunk``, the CLI and
bench.py run), ``StreamFleet`` and ``python -m lane_tracker_tpu`` — on the
one deployment the repo ships: assets/calibration.npz maps 1280x720 camera
frames to a 1080x1100 bird's-eye image, under the demo1 preset, in T=512
chunks with overlays.  What comes out is checked by the repo's own means:
the CPU backend of the same process, the committed bench oracles
(assets/bench_oracle*.npz) and unsharded replays.

Usage:
    python chip_smoke.py          # every phase, on one GPU
    python chip_smoke.py --four   # StreamFleet over four GPUs, nothing else

The card's ``nvidia-smi`` name and power limit come first.  Each phase then
prints one line: its name, compile seconds, run seconds and the device's
``peak_bytes_in_use`` so far.  Phases that run through a stateful entry
point (LaneTracker, StreamFleet) report their first call, compile
included, as the compile.  Any failed phase raises, so the exit code is
non-zero.  The last line is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed on a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Curve tolerance between two runs of the same decisions, in px.  Decision
# fields (validity, detection, attempts, search mode) are held exactly; the
# fitted coefficients may differ in their last bits where the f32 sums of
# the fit are ordered differently (another backend, another batch shape).
CURVE_TOL_PX = 0.5
RMSE_LIMIT_PX = 0.5  # curve RMSE against the live-reference oracle
# Undistort+warp against the CPU: bit-exact expected; the contract against
# OpenCV's float warp is <=1 unit on <0.05% of pixels (README).
WARP_MAX_SHARE = 5e-4
# LAB-B's fast arithmetic path against the LUT path: <=1 unit on <0.1% of
# pixels, the cube root's rare boundary rounding (ops/color.py).
LAB_MAX_SHARE = 1e-3
CARD_TESTS = "tests/test_on_card.py"


@dataclasses.dataclass(frozen=True)
class Deployment:
    """Calibration, preset and content one smoke run drives."""

    cam: object
    warp: object
    config: object  # TrackerConfig
    stills: np.ndarray  # (N, Hc, Wc, 3) uint8; the first two are the pair
    oracles: dict  # content name -> {'valid', 'left', 'right'}
    T: int = 512  # throughput chunk length
    fleet_T: int = 16
    col_roi: tuple | None = None  # corridor; None = the pipeline default


def full_deployment() -> Deployment:
    """The shipped deployment: 1280x720 -> 1080x1100, demo1, T=512."""
    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.tracker.config import PRESETS

    cam, warp = load_calibration_npz(os.path.join(REPO, "assets",
                                                  "calibration.npz"))
    stills = np.load(os.path.join(REPO, "assets", "stills.npz"))["frames"]
    oracles = {
        name: dict(np.load(os.path.join(REPO, "assets", f"{fname}.npz")))
        for name, fname in (("stills", "bench_oracle"),
                            ("fail16", "bench_oracle_fail16"))
    }
    return Deployment(cam, warp, PRESETS["demo1"], stills, oracles)


def process_kwargs(config) -> dict:
    """``LaneTracker.process`` keywords that reproduce ``config``."""
    f, s = config.filter, config.search
    kw = {k: getattr(f, k) for k in (
        "filter_type", "ksize_r", "C_r", "ksize_b", "C_b", "mask_noise",
        "noise_thresh", "ksize_noise", "C_noise")}
    kw.update({k: getattr(s, k) for k in (
        "window_width", "window_height", "search_range", "mu",
        "no_success_limit", "start_slice", "ignore_sides", "ignore_bottom",
        "bandwidth", "partial")})
    kw["n_tries"] = config.n_tries
    return kw


def build_params(dep: Deployment, pipeline: str):
    from lane_tracker_tpu.tracker.step import TrackerParams

    cam, warp = dep.cam, dep.warp
    kw = {"col_roi": dep.col_roi} if pipeline == "corridor" else {}
    return TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height,
        warp.mppv, warp.mpph, pipeline=pipeline, **kw)


def stills_chunk(dep: Deployment, T: int, fail_every: int = 0,
                 offset: int = 0) -> np.ndarray:
    """The stills cycled over T frames (the bench sequence), every
    ``fail_every``-th frame blacked out."""
    n = len(dep.stills)
    chunk = dep.stills[(np.arange(T) + offset) % n].copy()
    if fail_every:
        chunk[::fail_every] = 0
    return chunk


# ---------------------------------------------------------------------------
# gates


def curves(coeffs, H: int) -> np.ndarray:
    """x(y) of second-degree fits over the warped rows, (..., H)."""
    c = np.asarray(coeffs, np.float64)
    yy = np.arange(H, dtype=np.float64)
    return c[..., 0:1] * yy ** 2 + c[..., 1:2] * yy + c[..., 2:3]


def curve_max_diff_px(a, b, H: int) -> float:
    """Largest |x_a(y) - x_b(y)| over all rows and fits."""
    return float(np.abs(curves(a, H) - curves(b, H)).max(initial=0.0))


def rmse_px_max(valid, left, right, oracle, H: int) -> tuple[float, int]:
    """Largest per-curve RMSE against the oracle over the frames both
    call valid (bench.py's quality gate); returns (max, curves gated)."""
    valid = np.asarray(valid, bool)
    both = valid & np.asarray(oracle["valid"][:len(valid)], bool)
    idx = np.flatnonzero(both)
    rs = [np.sqrt(np.mean((curves(mine[idx], H) - curves(ref[idx], H)) ** 2,
                          axis=-1))
          for mine, ref in ((np.asarray(left), oracle["left"][:len(valid)]),
                            (np.asarray(right), oracle["right"][:len(valid)]))]
    rs = np.concatenate(rs)
    return float(rs.max(initial=0.0)), int(rs.size)


def trace_mismatches(valid, oracle) -> int:
    """Frames whose validity differs from the oracle's; the oracle must
    cover every frame."""
    valid = np.asarray(valid, bool)
    ov = np.asarray(oracle["valid"], bool)
    if len(ov) < len(valid):
        raise AssertionError(f"oracle covers {len(ov)} of {len(valid)} frames")
    return int((valid != ov[:len(valid)]).sum())


def gate_chunk(outs, oracle, H: int, corridor: bool) -> dict:
    """The throughput path's three gates: validity trace equal to the
    oracle on every frame, curve RMSE under RMSE_LIMIT_PX, and (corridor)
    the exactness certificate on every frame."""
    valid = np.asarray(outs.valid)
    bad = trace_mismatches(valid, oracle)
    rmse, n = rmse_px_max(valid, outs.left_coeffs, outs.right_coeffs,
                          oracle, H)
    cert = np.asarray(outs.corridor_ok, bool)
    info = {"frames": int(valid.size), "valid": int(valid.sum()),
            "second_attempts": int((np.asarray(outs.n_attempts) > 1).sum()),
            "trace_mismatches": bad, "rmse_px_max": rmse, "rmse_curves": n,
            "corridor_ok_share": float(cert.mean())}
    if bad:
        raise AssertionError(f"validity trace differs on {bad} frames")
    if not rmse < RMSE_LIMIT_PX:
        raise AssertionError(f"rmse_px_max {rmse} >= {RMSE_LIMIT_PX}")
    if corridor and not cert.all():
        raise AssertionError(
            f"corridor certificate failed on {int((~cert).sum())} frames")
    return info


def mismatch_stats(a, b) -> dict:
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return {"count": int((d != 0).sum()), "max": int(d.max(initial=0)),
            "share": float((d != 0).mean())}


# ---------------------------------------------------------------------------
# phases


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _host(tree):
    import jax

    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), tree,
        is_leaf=lambda x: x is None)


def phase_pair(dep: Deployment) -> dict:
    """LaneTracker.process on the pair: the first frame valid by sliding
    window, the second by band search; the CPU backend of this process
    must make the same decisions and fit the same curves."""
    import jax

    from lane_tracker_tpu.tracker.tracker import LaneTracker

    cam, warp, cfg = dep.cam, dep.warp, dep.config
    kw = process_kwargs(cfg)

    def make():
        return LaneTracker(
            warp.image_width_height, warp.warped_width_height,
            cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
            (warp.mppv, warp.mpph), n_fail=cfg.n_fail, n_reset=cfg.n_reset,
            n_average=cfg.n_average, validity=cfg.validity)

    def drive(tracker):
        outs = []
        for frame in dep.stills[:2]:
            tracker.process(frame, **kw)
            outs.append(_host(tracker.last_output))
        return outs

    _, compile_s = _timed(lambda: drive(make()))
    gpu, run_s = _timed(lambda: drive(make()))
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = drive(make())
    H = int(warp.warped_width_height[1])
    for i, (mode, name) in enumerate(((0, "sliding window"), (1, "band"))):
        for tag, o in (("gpu", gpu[i]), ("cpu", cpu[i])):
            if not (bool(o.valid) and int(o.search_mode) == mode):
                raise AssertionError(
                    f"{tag} frame {i}: valid={bool(o.valid)} search_mode="
                    f"{int(o.search_mode)}, expected valid by {name}")
    diff = max(curve_max_diff_px(np.stack([g.left_coeffs, g.right_coeffs]),
                                 np.stack([c.left_coeffs, c.right_coeffs]), H)
               for g, c in zip(gpu, cpu))
    radius = max(abs(float(g.radius) - float(c.radius)) / abs(float(c.radius))
                 for g, c in zip(gpu, cpu))
    ecc = max(abs(float(g.ecc) - float(c.ecc)) for g, c in zip(gpu, cpu))
    info = {"compile_s": compile_s, "run_s": run_s,
            "curve_max_diff_px": diff, "radius_rel_diff": radius,
            "ecc_diff_m": ecc, "radius_m": float(gpu[1].radius),
            "ecc_m": float(gpu[1].ecc)}
    if diff > CURVE_TOL_PX:
        raise AssertionError(f"curves differ by {diff} px from the CPU")
    # The shown radius is a truncated mean of 1/curvature and the
    # eccentricity a truncated bottom point times m/px: allow 1% and two
    # one-pixel truncation flips.
    if radius > 0.01 or ecc > 2 * float(warp.mpph):
        raise AssertionError(f"radius/ecc differ from the CPU: {info}")
    return info


def phase_stages(dep: Deployment) -> dict:
    """Each stage on two real frames, on the default device and on the
    CPU: warp and LAB-B within their contracts, filter binaries and row
    prefixes bit-exact, the latency-mode resampler bit-exact against the
    gather path."""
    import jax
    import jax.numpy as jnp

    from lane_tracker_tpu.ops.color import rgb2lab_b_fast, rgb2lab_b_u8
    from lane_tracker_tpu.ops.integrals import (
        build_row_prefixes,
        row_prefixes_reference,
    )
    from lane_tracker_tpu.tracker.config import SECOND_ATTEMPT
    from lane_tracker_tpu.tracker.step import _filter_batch, _warp_rgb

    cpu = jax.devices("cpu")[0]
    params = build_params(dep, "fast")
    params_mm = params.with_rowmm()
    frames = dep.stills[:2]
    warp = jax.jit(jax.vmap(lambda f, p: jnp.stack(_warp_rgb(f, p)),
                            in_axes=(0, None)))
    lab_fast = jax.jit(jax.vmap(lambda w: rgb2lab_b_fast(
        jnp.moveaxis(w, 0, -1))))
    lab_lut = jax.jit(jax.vmap(lambda w: rgb2lab_b_u8(
        jnp.moveaxis(w, 0, -1))))
    filt1 = jax.jit(lambda r, b: _filter_batch(r, b, dep.config.filter))
    filt2 = jax.jit(lambda r, b: _filter_batch(r, b, SECOND_ATTEMPT.filter))
    pref = jax.jit(jax.vmap(lambda b: build_row_prefixes(b).packed))

    # The CPU reference of every stage, on the CPU's own inputs.
    on_cpu = lambda f, *a: np.asarray(f(*jax.device_put(a, cpu)))  # noqa: E731
    w_c = on_cpu(warp, frames, params)
    labf_c = on_cpu(lab_fast, w_c)
    lut_c = on_cpu(lab_lut, w_c)
    r_c = w_c[:, 0]
    bin1_c = on_cpu(filt1, r_c, labf_c)
    bin2_c = on_cpu(filt2, r_c, labf_c)
    H, W = bin1_c.shape[1:]
    ones = np.full((1, H, W), 255, np.uint8)
    pref_in = np.concatenate([bin1_c, bin2_c, ones])
    pref_c = on_cpu(pref, pref_in)

    # The same stages on the default device, each given the CPU's input
    # so that one stage's difference does not spill into the next.
    dev = jax.devices()[0]
    jobs = {
        "warp": (warp, (frames, params)),
        "rowmm": (warp, (frames, params_mm)),
        "lab_fast": (lab_fast, (w_c,)),
        "filter_a1": (filt1, (r_c, labf_c)),
        "filter_a2": (filt2, (r_c, labf_c)),
        "prefixes": (pref, (pref_in,)),
    }
    compile_s = run_s = 0.0
    got = {}
    for name, (fn, args) in jobs.items():
        args = jax.device_put(args, dev)
        t0 = time.perf_counter()
        exe = fn.lower(*args).compile()
        t1 = time.perf_counter()
        got[name] = np.asarray(jax.block_until_ready(exe(*args)))
        compile_s += t1 - t0
        run_s += time.perf_counter() - t1

    pref_ref = row_prefixes_reference(pref_in)
    stats = {
        "warp": mismatch_stats(got["warp"], w_c),
        "lab_fast_vs_cpu_fast": mismatch_stats(got["lab_fast"], labf_c),
        "lab_fast_vs_lut": mismatch_stats(got["lab_fast"], lut_c),
        "filter_a1": mismatch_stats(got["filter_a1"], bin1_c),
        "filter_a2": mismatch_stats(got["filter_a2"], bin2_c),
        "prefixes": mismatch_stats(got["prefixes"], pref_c),
        "prefixes_vs_cumsum": mismatch_stats(got["prefixes"], pref_ref),
        "rowmm_vs_gather": mismatch_stats(got["rowmm"], got["warp"]),
    }
    w, lab = stats["warp"], stats["lab_fast_vs_lut"]
    if w["max"] > 1 or w["share"] >= WARP_MAX_SHARE:
        raise AssertionError(f"warp outside its contract: {w}")
    if lab["max"] > 1 or lab["share"] >= LAB_MAX_SHARE:
        raise AssertionError(f"LAB-B outside its contract: {lab}")
    for name in ("filter_a1", "filter_a2", "prefixes", "prefixes_vs_cumsum",
                 "rowmm_vs_gather"):
        if stats[name]["count"]:
            raise AssertionError(f"{name} not bit-exact: {stats[name]}")
    info = {"compile_s": compile_s, "run_s": run_s}
    info.update({f"{k}_mismatch": v["count"] for k, v in stats.items()})
    info.update(warp_values=int(got["warp"].size), warp_max_diff=w["max"],
                lab_fast_vs_lut_max_diff=lab["max"],
                lab_fast_vs_lut_share=lab["share"])
    return info


def phase_chunk(dep: Deployment, pipeline: str, content: str,
                compiled: dict) -> dict:
    """The throughput path on a T-frame chunk: two-phase second attempt,
    overlays on, gated against the content's oracle.  ``compiled`` keeps
    each pipeline's executable for the next content."""
    import jax

    from lane_tracker_tpu.parallel.pipeline import build_chunk_processor
    from lane_tracker_tpu.tracker.step import make_initial_state

    params = build_params(dep, pipeline)
    cfg = dep.config
    fail_every = {"stills": 0, "fail16": 16}[content]
    chunk = jax.device_put(stills_chunk(dep, dep.T, fail_every))
    state = make_initial_state(cfg, params.warped_size)
    compile_s = 0.0
    if pipeline not in compiled:
        step = build_chunk_processor(cfg, with_overlay=True,
                                     second_attempt="two_phase")
        t0 = time.perf_counter()
        compiled[pipeline] = step.lower(state, chunk, params).compile()
        compile_s = time.perf_counter() - t0
    (_, outs), run_s = _timed(lambda: compiled[pipeline](state, chunk,
                                                         params))
    Hc, Wc = dep.stills.shape[1:3]
    if outs.overlay.shape != (dep.T, Hc, Wc, 3):
        raise AssertionError(f"overlay shape {outs.overlay.shape}")
    H = int(params.warped_size[1])
    info = {"compile_s": compile_s, "run_s": run_s}
    info.update(gate_chunk(_host(outs), dep.oracles[content], H,
                           corridor=pipeline == "corridor"))
    if fail_every and not info["second_attempts"]:
        raise AssertionError("the second attempt never ran")
    return info


def fleet_frames(dep: Deployment, n_streams: int, T: int,
                 dead: int) -> np.ndarray:
    """(S, T, Hc, Wc, 3): each stream cycles the stills from its own
    offset; stream ``dead`` is a black (dead) camera."""
    frames = np.stack([stills_chunk(dep, T, offset=s)
                       for s in range(n_streams)])
    frames[dead] = 0
    return frames


def phase_fleet(dep: Deployment, schedule: str, n_streams: int = 8,
                T: int | None = None, dead: int = 3, mesh=None) -> dict:
    """StreamFleet against an unsharded chunk_process replay of each
    stream: decisions equal, curves within CURVE_TOL_PX, the psum'd
    metrics equal to the replay's totals.  With a mesh over several
    devices, the state and frame shards must lie on distinct devices."""
    import jax

    from lane_tracker_tpu.parallel.mesh import stream_mesh
    from lane_tracker_tpu.parallel.pipeline import build_chunk_processor
    from lane_tracker_tpu.parallel.streams import StreamFleet
    from lane_tracker_tpu.tracker.step import make_initial_state

    T = T or dep.fleet_T
    mesh = mesh if mesh is not None else stream_mesh(1)
    params = build_params(dep, "corridor")
    cfg = dep.config
    frames = fleet_frames(dep, n_streams, T, dead)

    def run():
        fleet = StreamFleet(params, cfg, n_streams, mesh=mesh,
                            second_attempt=schedule)
        frames_d = jax.device_put(frames, fleet.frame_sharding())
        outs, metrics = fleet.step(frames_d)
        return fleet, frames_d, outs, metrics

    _, compile_s = _timed(run)
    (fleet, frames_d, outs, metrics), run_s = _timed(run)
    n_dev = mesh.shape["stream"]
    for name, arr in (("states", fleet.states.counter), ("frames", frames_d),
                      ("outputs", outs.valid)):
        devs = {s.device for s in arr.addressable_shards}
        if len(devs) != n_dev:
            raise AssertionError(f"{name} on {len(devs)} devices, not {n_dev}")
    outs, metrics = _host(outs), _host(metrics)

    replay = build_chunk_processor(cfg, with_overlay=False,
                                   second_attempt="two_phase")
    single = make_initial_state(cfg, params.warped_size)
    H = int(params.warped_size[1])
    totals = dict.fromkeys(("frames", "valid_frames", "detected_frames",
                            "second_attempts"), 0)
    diff = 0.0
    for s in range(n_streams):
        _, ref = replay(single, frames[s], params)
        ref = _host(ref)
        for name in ("valid", "detected", "n_attempts", "search_mode"):
            np.testing.assert_array_equal(getattr(outs, name)[s],
                                          getattr(ref, name),
                                          err_msg=f"stream {s}: {name}")
        diff = max(diff, curve_max_diff_px(
            np.stack([outs.left_coeffs[s], outs.right_coeffs[s]]),
            np.stack([ref.left_coeffs, ref.right_coeffs]), H))
        totals["frames"] += T
        totals["valid_frames"] += int(ref.valid.sum())
        totals["detected_frames"] += int(ref.detected.sum())
        totals["second_attempts"] += int((ref.n_attempts > 1).sum())
    got = {k: int(v) for k, v in metrics.items()}
    if got != totals:
        raise AssertionError(f"fleet metrics {got} != replay {totals}")
    if diff > CURVE_TOL_PX:
        raise AssertionError(f"fleet curves differ by {diff} px")
    if not outs.valid[np.arange(n_streams) != dead].any():
        raise AssertionError("no live stream tracked")
    return {"compile_s": compile_s, "run_s": run_s, "devices": n_dev,
            "curve_max_diff_px": diff, **got}


def phase_cli(dep: Deployment) -> dict:
    """``python -m lane_tracker_tpu`` on a .npz frame stack of the
    stills; its per-frame log must match the stills oracle."""
    from lane_tracker_tpu.process_video import run

    n = len(dep.stills)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.npz")
        np.savez(src, frames=dep.stills)
        log = os.path.join(tmp, "log.jsonl")
        calib = os.path.join(tmp, "calibration.npz")
        from lane_tracker_tpu.calib.io import save_calibration_npz

        save_calibration_npz(calib, dep.cam, dep.warp)
        argv = [src, os.path.join(tmp, "out.npz"), "--calibration", calib,
                "--chunk", str(n), "--per-frame-log", log]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # its own report
            run(argv)
        run_s = time.perf_counter() - t0
        with open(log) as f:
            valid = [json.loads(ln)["valid"] for ln in f]
        with np.load(os.path.join(tmp, "out.npz")) as out:
            shape = out["frames"].shape
    bad = trace_mismatches(valid, dep.oracles["stills"])
    if len(valid) != n or bad or shape != dep.stills.shape:
        raise AssertionError(f"CLI: {len(valid)} frames logged, {bad} "
                             f"differ from the oracle, output {shape}")
    return {"compile_s": None, "run_s": run_s, "frames": n,
            "trace_mismatches": bad}


def phase_card_tests(require_card: bool = True) -> dict:
    """The pytest tests marked ``gpu``, in a child process that has the
    card to itself (this process has not touched it yet)."""
    env = dict(os.environ)
    if require_card:
        env["LT_TESTS_ON_CARD"] = "1"
    cmd = [sys.executable, "-m", "pytest", CARD_TESTS, "-m", "gpu", "-q",
           "-p", "no:cacheprovider"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True)
    run_s = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    if res.returncode != 0:
        sys.stdout.write(res.stdout[-8000:] + res.stderr[-4000:])
        raise AssertionError(f"card tests failed (rc {res.returncode}): "
                             f"{summary}")
    return {"compile_s": None, "run_s": run_s, "summary": repr(summary),
            "peak_bytes_in_use": "n/a (child process)"}


def run_phase(name: str, fn, *args, **kwargs) -> dict:
    """Run one phase and print its line; a failure propagates."""
    info = fn(*args, **kwargs)
    if "peak_bytes_in_use" not in info:
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        info["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    head = " ".join(f"{k}={_fmt(info.pop(k), 3)}"
                    for k in ("compile_s", "run_s", "peak_bytes_in_use"))
    rest = " ".join(f"{k}={_fmt(v)}" for k, v in info.items())
    print(f"phase {name}: {head} {rest}".rstrip(), flush=True)
    return info


def _fmt(v, digits=None):
    if isinstance(v, float):
        return f"{v:.{digits}f}" if digits else repr(v)
    return str(v)


def default_phases(dep: Deployment):
    """(name, fn, args) of the one-card phases after the card tests."""
    compiled = {}
    phases = [("pair", phase_pair, (dep,)),
              ("stages", phase_stages, (dep,))]
    for content in ("stills", "fail16"):
        for pipeline in ("corridor", "fast"):
            phases.append((f"{content}_{pipeline}", phase_chunk,
                           (dep, pipeline, content, compiled)))
    for schedule in ("two_phase", "hoist"):
        phases.append((f"fleet_{schedule}", phase_fleet, (dep, schedule)))
    phases.append(("cli", phase_cli, (dep,)))
    return phases


def four_phases(dep: Deployment, n_devices: int = 4):
    """The --four phases: StreamFleet over a 4-device stream mesh, 8
    streams (2 per device), T=32, one dead camera."""
    from lane_tracker_tpu.parallel.mesh import stream_mesh

    mesh = stream_mesh(n_devices)
    return [(f"fleet4_{schedule}", phase_fleet,
             (dep, schedule, 2 * n_devices, 32, 3, mesh))
            for schedule in ("two_phase", "hoist")]


def print_memory_per_device():
    import jax

    for d in jax.devices():
        stats = d.memory_stats() or {}
        print(f"memory {d}: peak_bytes_in_use={stats.get('peak_bytes_in_use')}"
              f" bytes_in_use={stats.get('bytes_in_use')}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only StreamFleet over four GPUs")
    args = ap.parse_args(argv)

    from lane_tracker_tpu.utils.card import card_name_and_power_limit

    print(card_name_and_power_limit(), flush=True)
    if not args.four:
        run_phase("card_tests", phase_card_tests)

    from lane_tracker_tpu.utils.card import device_summary, require_gpu
    from lane_tracker_tpu.utils.compile_cache import setup_compile_cache

    devices = require_gpu()
    setup_compile_cache()
    dep = full_deployment()
    if args.four:
        if len(devices) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
        phases = four_phases(dep)
    else:
        phases = default_phases(dep)
    for name, fn, fargs in phases:
        run_phase(name, fn, *fargs)
    if args.four:
        print_memory_per_device()
    summary = device_summary()
    if args.four and summary["count"] != 4:
        raise SystemExit(f"--four ran on {summary['count']} devices")
    print(json.dumps({"ok": True, "device": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
