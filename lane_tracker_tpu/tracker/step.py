"""The pure per-frame tracking step.

This is the JAX re-design of ``LaneTracker.process``
(lane_tracker.py:876-1209) as a pure function::

    step : (TrackerState, frame) -> (TrackerState, StepOutput)

All control flow of the reference's state machine is preserved under
``lax.cond`` / ``jnp.where``: the two-attempt fallback (lane_tracker.py:
1071-1128, second attempt with the hardcoded 'neighborhood' parameter set),
the band-vs-sliding-window mode select on ``last_detection`` (lane_tracker.
py:851), the rolling-history push/pop with failure sentinels (1145-1156,
1180-1187), smoothing over valid history entries (1194-1197), curve radius
and eccentricity bookkeeping (530-559), and the failure rendering grace
period (1160-1173).

Because ``step`` is pure and fixed-shape it jits once per config, scans
over the video time axis, vmaps over frame microbatches of independent
streams, and shards across chips with jax.sharding — none of which the
reference's mutable-object design could express.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lane_tracker_tpu.calib.homography import perspective_grid
from lane_tracker_tpu.calib.undistort import undistort_grid
from lane_tracker_tpu.kernels.resample import (
    ResampleGrid,
    bilinear_gather,
    bilinear_gather_pair,
)
from lane_tracker_tpu.ops.color import rgb2lab_b_fast, rgb2lab_b_u8
from lane_tracker_tpu.ops.filters import filter_lane_points_channels
from lane_tracker_tpu.ops.integrals import RowPrefixes, build_row_prefixes, interval_moments
from lane_tracker_tpu.ops.polyfit import (
    check_validity,
    curve_radius_m,
    eccentricity_m,
    fit_poly_rows,
    ploty_grid,
    poly_points_meta,
)
from lane_tracker_tpu.ops.search import (
    SearchIntervals,
    SwsPrecomp,
    band_intervals,
    sliding_window_intervals,
    sws_precompute,
)
from lane_tracker_tpu.render.lane import (
    forward_bv_grid,
    lane_overlay,
    lane_overlay_direct,
    lane_region_mask,
)
from lane_tracker_tpu.tracker.config import (
    SECOND_ATTEMPT,
    SECOND_ATTEMPT_HALF,
    TrackerConfig,
)
from lane_tracker_tpu.tracker.state import TrackerState, init_state


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TrackerParams:
    """Device-resident calibration-derived constants.

    Built once per calibration (grids are precomputed on the host); static
    geometry/metric scalars ride in the pytree aux so they are jit-static.
    """

    grid_und: ResampleGrid  # undistort resampling grid (full frame)
    grid_warp: ResampleGrid  # bird's-eye warp resampling grid (full und)
    grid_und_roi: ResampleGrid | None  # und cropped to warp-sampled rows
    grid_warp_roi: ResampleGrid | None  # warp rebased onto the cropped und
    unwarp_grid: ResampleGrid  # bird's-eye -> camera view (compat render)
    fwd_u: jnp.ndarray  # (Hc, Wc) f32 — camera pixel's BV x (direct render)
    fwd_v: jnp.ndarray  # (Hc, Wc) f32 — camera pixel's BV y
    img_size: tuple  # (W, H) camera frames
    warped_size: tuple  # (W, H) bird's-eye
    mppv: float
    mpph: float
    pipeline: str  # 'fast' | 'compat' | 'turbo'
    raw_roi: tuple = (0, 0)  # raw-frame row range feeding grid_und_roi
    # 'corridor' only: warped columns [x0, x1) whose filter decisions are
    # kept; None = full width.
    col_roi: tuple | None = None
    # 'corridor' only: warped columns [c0, c1) the warp/LAB/filter
    # actually COMPUTE — col_roi expanded by the filter chain's influence
    # radius (tophat55 54 + ksize_b 17 + open5 4 = 75 px, padded to 80),
    # so every kept column's binary value is bit-exact vs full-width
    # 'fast': its whole influence cone is computed, never neutral-filled.
    col_comp: tuple | None = None
    # 'half' only: the warped space is built at 1/res_scale of the
    # caller's warped_size (scaled M, doubled m/px) — a measured
    # approximation; configs must be scaled with config.halve_config
    # (LaneTracker does this automatically).
    res_scale: int = 1
    # 'turbo' only: f32 (Hw, Ww) map = 128*(1 - sum(warp weights)) — the
    # LAB-B out-of-image fill restoration (LAB-B of black is 128, but a
    # warped channel's out-of-bounds taps carry weight 0).
    warp_b_bias: jnp.ndarray | None = None
    # Latency mode (opt-in via with_rowmm()): tile-structured resampling
    # grids replacing the per-pixel gathers with slab reads + one-hot
    # matmul contractions — bit-identical outputs, aimed at small-T and
    # per-frame programs (kernels/resample_rowmm.py).
    mm_und: object | None = None
    mm_warp: object | None = None

    def tree_flatten(self):
        children = (
            self.grid_und,
            self.grid_warp,
            self.grid_und_roi,
            self.grid_warp_roi,
            self.unwarp_grid,
            self.fwd_u,
            self.fwd_v,
            self.warp_b_bias,
            self.mm_und,
            self.mm_warp,
        )
        aux = (
            self.img_size,
            self.warped_size,
            self.mppv,
            self.mpph,
            self.pipeline,
            self.raw_roi,
            self.col_roi,
            self.col_comp,
            self.res_scale,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        *grids, bias, mm_und, mm_warp = children
        return cls(*grids, *aux, warp_b_bias=bias, mm_und=mm_und,
                   mm_warp=mm_warp)

    def with_rowmm(self) -> "TrackerParams":
        """Params carrying the latency-mode resampling structure: the
        two-stage warp runs as slab gathers + one-hot matmul contractions
        (kernels/resample_rowmm.py), bit-identical to the gather path.
        Opt-in because the one-hot tensors hold ~400 MB of device memory
        and can only pay off in single-frame and small-chunk programs."""
        if self.pipeline == "compat" or self.grid_und_roi is None:
            return self
        from lane_tracker_tpu.kernels.resample_rowmm import build_rowmm

        return dataclasses.replace(
            self,
            mm_und=build_rowmm(self.grid_und_roi),
            mm_warp=build_rowmm(self.grid_warp_roi),
        )

    @classmethod
    def build(
        cls,
        cam_matrix,
        dist_coeffs,
        M,
        Minv,
        img_size,
        warped_size,
        mppv,
        mpph,
        pipeline: str = "fast",
        col_roi: tuple | None = None,
    ) -> "TrackerParams":
        img_size = tuple(int(v) for v in img_size)
        warped_size = tuple(int(v) for v in warped_size)
        res_scale = 1
        if pipeline == "half":
            # 'half': MEASURED-APPROXIMATION pipeline (opt-in) — the
            # whole warped-space chain (warp, LAB, filter, search, fit)
            # runs at half the warped resolution (round-4 verdict item
            # 2a).  Implemented as a scaled calibration: the half-res
            # pixel (x, y) has its center at full-res (2x + 0.5,
            # 2y + 0.5), so M_h = S @ M with S = [[.5, 0, -.25],
            # [0, .5, -.25], [0, 0, 1]], meters-per-pixel double, and
            # every px-denominated config knob halves
            # (config.halve_config; LaneTracker applies it).  Geometry
            # is otherwise the reference's exact two-stage chain; the
            # deviation is resolution (scripts/approx_quality.py).
            # Internally this behaves as 'fast' at the scaled sizes.
            res_scale = 2
            S = np.array([[0.5, 0.0, -0.25],
                          [0.0, 0.5, -0.25],
                          [0.0, 0.0, 1.0]])
            M = S @ np.asarray(M)
            Minv = np.asarray(Minv) @ np.linalg.inv(S)
            warped_size = (warped_size[0] // 2, warped_size[1] // 2)
            mppv = float(mppv) * 2
            mpph = float(mpph) * 2
        unwarp = ResampleGrid.from_quantized(
            perspective_grid(np.asarray(Minv), warped_size, img_size, mode="float")
        )
        fu, fv = forward_bv_grid(np.asarray(M), img_size, warped_size)
        if pipeline not in ("compat", "fast", "turbo", "corridor", "half"):
            raise ValueError("pipeline must be 'fast', 'compat', 'turbo',"
                             " 'corridor' or 'half'")
        # Both pipelines use the reference's exact two-stage resampling
        # chain (lane_tracker.py:832-834); they differ in how channels
        # are packed through it and in the render path.
        und_q = undistort_grid(cam_matrix, dist_coeffs, img_size)
        g_und = ResampleGrid.from_quantized(und_q)
        g_warp = ResampleGrid.from_quantized(
            perspective_grid(np.asarray(M), img_size, warped_size, mode="float")
        )
        g_und_roi = g_warp_roi = None
        raw_roi = (0, int(img_size[1]))
        if pipeline in ("fast", "turbo", "corridor", "half"):
            g_und_roi, g_warp_roi, raw_roi = _roi_grids(
                und_q, g_warp, img_size)
        if pipeline == "corridor":
            # 'corridor': MEASURED-APPROXIMATION pipeline (opt-in) — the
            # column analogue of the row ROI (round-4 verdict item 2b).
            # The warp/LAB/filter compute only warped columns [c0, c1) =
            # [x0 - 80, x1 + 80) and keep decisions in [x0, x1); outside
            # the corridor the binary is declared empty.  The computed
            # columns' channel values are bit-identical to 'fast' (pure
            # host-side grid cropping: same taps and weights), and the
            # 80 px compute margin exceeds the filter chain's influence
            # radius (tophat55 erode+dilate 54 + ksize_b=35 window 17 +
            # open5 4 = 75; the noise mask's 32 and the second attempt's
            # 21 are smaller), so every KEPT column is bit-exact vs
            # full-width 'fast' — the margin-0 variant measured 0.757 px
            # max from edge-halo flips; with the margin the only
            # deviation left is candidate pixels genuinely outside
            # [x0, x1).  Sizing evidence: the reference's fitted curves
            # span x in [420, 760] over the bench + motion oracles, the
            # SWS seed histogram reads [ignore_sides, W-ignore_sides) =
            # [360, 720), and band search adds bandwidth <= 30 — the
            # default [320, 832) leaves >= 70 px of slack on each side.
            if col_roi is None:
                col_roi = (320, 832)
            cx0, cx1 = (int(col_roi[0]), int(col_roi[1]))
            if not (0 <= cx0 < cx1 <= warped_size[0]):
                raise ValueError(f"col_roi {col_roi} outside warped width")
            col_roi = (cx0, cx1)
            margin = 80
            cc0, cc1 = max(0, cx0 - margin), min(warped_size[0],
                                                 cx1 + margin)
            col_comp = (cc0, cc1)
            g_warp_roi = dataclasses.replace(
                g_warp_roi,
                base=g_warp_roi.base[:, cc0:cc1],
                w00=g_warp_roi.w00[:, cc0:cc1],
                w01=g_warp_roi.w01[:, cc0:cc1],
                w10=g_warp_roi.w10[:, cc0:cc1],
                w11=g_warp_roi.w11[:, cc0:cc1],
            )
        else:
            col_roi = None
            col_comp = None
        warp_b_bias = None
        if pipeline == "turbo":
            wsum = (np.asarray(g_warp_roi.w00) + np.asarray(g_warp_roi.w01)
                    + np.asarray(g_warp_roi.w10) + np.asarray(g_warp_roi.w11))
            warp_b_bias = jnp.asarray(
                128.0 * (1.0 - wsum.astype(np.float32)))
        return cls(
            grid_und=g_und,
            grid_warp=g_warp,
            grid_und_roi=g_und_roi,
            grid_warp_roi=g_warp_roi,
            unwarp_grid=unwarp,
            fwd_u=jnp.asarray(fu),
            fwd_v=jnp.asarray(fv),
            img_size=img_size,
            warped_size=warped_size,
            mppv=float(mppv),
            mpph=float(mpph),
            pipeline=pipeline,
            raw_roi=raw_roi,
            col_roi=col_roi,
            col_comp=col_comp,
            res_scale=res_scale,
            warp_b_bias=warp_b_bias,
        )


class StepOutput(NamedTuple):
    overlay: jnp.ndarray  # (Hc, Wc, 3) uint8 — lane-highlighted frame
    render_mode: jnp.ndarray  # () i32: 0 = lane drawn, 1 = failure text
    valid: jnp.ndarray  # () bool — this frame produced valid lane lines
    detected: jnp.ndarray  # () bool — lane pixels found (final attempt)
    search_mode: jnp.ndarray  # () i32: 0 = sliding window, 1 = band
    n_attempts: jnp.ndarray  # () i32
    radius: jnp.ndarray  # () f32 — smoothed curve radius shown (m)
    ecc: jnp.ndarray  # () f32 — eccentricity shown (m)
    left_coeffs: jnp.ndarray  # (3,) f32 — this frame's raw fit
    right_coeffs: jnp.ndarray  # (3,) f32
    n_points_left: jnp.ndarray  # () i32 — validity sample counts
    n_points_right: jnp.ndarray  # () i32
    # Attempt-1 outcome (equal to the final fields when only one attempt
    # ran); lets diagnostics narrate both attempts exactly like the
    # reference's per-attempt prints (lane_tracker.py:1062-1143).
    a1_detected: jnp.ndarray  # () bool
    a1_valid: jnp.ndarray  # () bool
    a1_left_coeffs: jnp.ndarray  # (3,) f32
    a1_right_coeffs: jnp.ndarray  # (3,) f32
    a1_n_left: jnp.ndarray  # () i32
    a1_n_right: jnp.ndarray  # () i32
    # 'corridor' only (constant True otherwise): every search read this
    # frame's executed attempts made stayed inside the corridor, so the
    # frame's decision trace is certified bit-identical to 'fast'.
    corridor_ok: jnp.ndarray = True  # () bool


class AttemptResult(NamedTuple):
    detected: jnp.ndarray
    valid: jnp.ndarray
    lc: jnp.ndarray
    rc: jnp.ndarray
    search_mode: jnp.ndarray
    n_left: jnp.ndarray
    n_right: jnp.ndarray
    # 'corridor' exactness certificate: True iff every binary-column
    # read this attempt made stayed inside the decision corridor, which
    # (with the margin-exact interior) makes the attempt bit-identical
    # to full-width 'fast' by induction.  Constant True off-corridor.
    roi_ok: jnp.ndarray = True


def _roi_grids(und_q: dict, g_warp: ResampleGrid, img_size):
    """Row-crop the two-stage resampling chain to what is actually sampled.

    The bird's-eye warp samples only a horizontal band of the undistorted
    frame (the road trapezoid — measured rows 457..695 of 720 for the
    shipped calibration), and that band of the undistort grid samples a
    similar band of the raw frame.  Cropping is pure host-side index
    rebasing: identical taps and weights, so results stay bit-identical
    while the undistort stage computes ~3x fewer pixels.

    Returns (g_und_roi, g_warp_roi, (ry0, ry1)): the undistort grid
    restricted to warp-sampled rows and reading raw rows [ry0, ry1), and
    the warp grid rebased onto that cropped undistorted band.
    """
    Wc, Hc = int(img_size[0]), int(img_size[1])
    wb = np.asarray(g_warp.base)
    y0 = int((wb // Wc).min())
    y1 = min(int((wb // Wc).max()) + 2, Hc)  # +1 down tap, +1 exclusive
    und_rows = {
        k: (v[y0:y1] if isinstance(v, np.ndarray) and v.ndim == 2 else v)
        for k, v in und_q.items()
    }
    g_und_band = ResampleGrid.from_quantized(und_rows)
    ub = np.asarray(g_und_band.base)
    ry0 = int((ub // Wc).min())
    ry1 = min(int((ub // Wc).max()) + 2, Hc)
    g_und_roi = dataclasses.replace(
        g_und_band,
        base=g_und_band.base - jnp.int32(ry0 * Wc),
        src_size=(Wc, ry1 - ry0),
    )
    g_warp_roi = dataclasses.replace(
        g_warp,
        base=g_warp.base - jnp.int32(y0 * Wc),
        src_size=(Wc, y1 - y0),
    )
    return g_und_roi, g_warp_roi, (ry0, ry1)


def _undistort_rgb(frame, params: TrackerParams):
    """The undistort stage of the exact two-stage chain, ROI-cropped
    (_roi_grids): the three undistorted planes of the rows the warp
    samples, computed from only the raw rows those need."""
    ry0, ry1 = params.raw_roi
    sub = frame[ry0:ry1]
    if params.mm_und is not None:
        # Latency mode (with_rowmm): same taps/weights via slab reads +
        # one-hot matmul contractions — bit-identical
        # (kernels/resample_rowmm.py).
        from lane_tracker_tpu.kernels.resample_rowmm import (
            gather_planes_rowmm,
        )

        return tuple(gather_planes_rowmm(
            jnp.moveaxis(sub, -1, 0), params.grid_und_roi, params.mm_und))
    r_u, g_u = bilinear_gather_pair(sub[..., 0], sub[..., 1],
                                    params.grid_und_roi)
    b_u = bilinear_gather(sub[..., 2], params.grid_und_roi)
    return r_u, g_u, b_u


def _warp_rgb(frame, params: TrackerParams):
    """The warped R, G, B planes of the exact two-stage chain (undistort
    then warp, lane_tracker.py:832-834) — the input of LAB-B on every
    non-compat pipeline except 'turbo'."""
    r_u, g_u, b_u = _undistort_rgb(frame, params)
    if params.mm_warp is not None:
        from lane_tracker_tpu.kernels.resample_rowmm import (
            gather_planes_rowmm,
        )

        return tuple(gather_planes_rowmm(
            jnp.stack([r_u, g_u, b_u]), params.grid_warp_roi,
            params.mm_warp))
    r_w, g_w = bilinear_gather_pair(r_u, g_u, params.grid_warp_roi)
    b_w = bilinear_gather(b_u, params.grid_warp_roi)
    return r_w, g_w, b_w


def _warp_channels(frame, params: TrackerParams):
    """Produce the warped R and LAB-B channels for the filter stage.

    'compat' chains undistort -> warp -> LAB exactly like the reference
    (lane_tracker.py:832-834, 207-208).  The other pipelines run the same
    exact resampling chain, ROI-cropped (_warp_rgb), and evaluate LAB-B
    arithmetically instead of through the LUT.
    """
    if params.pipeline == "compat":
        und = bilinear_gather(frame, params.grid_und)
        warped = bilinear_gather(und, params.grid_warp)
        return warped[..., 0], rgb2lab_b_u8(warped)
    # The channels are bit-identical to 'compat' (pair gathers use
    # exactly the taps and weights of the single-channel calls); the only
    # deviation left is rgb2lab_b_fast's arithmetic vs LUT evaluation
    # (<=1 unit on <0.1% of pixels).  Corpus-measured: any resampling
    # shortcut breaks parity — the one-gather fused resample flipped
    # 2-25% of white pixels (curve RMSE up to 147 px on marginal frames)
    # and even raw-frame LAB with exact two-stage warps flipped a longrun
    # validity (RMSE 3.0 px), so the pipeline pays for the full chain.
    if params.pipeline == "turbo":
        # 'turbo': MEASURED-APPROXIMATION pipeline (opt-in; quality
        # measured in scripts/turbo_quality.py).  LAB-B is computed on
        # the undistorted band (~0.31 MP instead of the 1.19 MP warped
        # frame) and the stage-2 warp resamples only R + LAB-B as ONE
        # pair gather.  Geometry is the reference's exact two-stage
        # chain; the only deviation vs 'fast' is interpolate(LAB(x))
        # instead of LAB(interpolate(x)) across the warp — the reference
        # computes LAB on the warped frame (lane_tracker.py:832-834,
        # 207-208), and the two differ by the nonlinearity's Jensen gap
        # on blended edge pixels.
        r_u, g_u, b_u = _undistort_rgb(frame, params)
        lab_u = rgb2lab_b_fast(jnp.stack([r_u, g_u, b_u], axis=-1))
        if params.mm_warp is not None:
            from lane_tracker_tpu.kernels.resample_rowmm import (
                bilinear_gather_pair_rowmm,
            )

            return bilinear_gather_pair_rowmm(
                r_u, lab_u, params.grid_warp_roi, params.mm_warp,
                bias_b=params.warp_b_bias)
        return bilinear_gather_pair(r_u, lab_u, params.grid_warp_roi,
                                    bias_b=params.warp_b_bias)
    r_w, g_w, b_w = _warp_rgb(frame, params)
    return r_w, rgb2lab_b_fast(jnp.stack([r_w, g_w, b_w], axis=-1))


def _embed_cols(binary, params: TrackerParams):
    """Slice a compute-window binary down to the decision corridor and
    embed it back into the full warped width (zeros outside [x0, x1)) so
    the search/fit/validity semantics — and every x coordinate
    downstream — stay in full warped coordinates.  The dropped margin
    columns exist only to feed the kept columns' influence cones."""
    if params.col_roi is None:
        return binary
    x0, x1 = params.col_roi
    c0, c1 = params.col_comp
    W = params.warped_size[0]
    binary = binary[..., x0 - c0:x1 - c0]
    pad = [(0, 0)] * (binary.ndim - 1) + [(x0, W - x1)]
    return jnp.pad(binary, pad)


# Chunks at or beyond this T run the warp+LAB stage through lax.map in
# blocks of _WARP_MAP_BATCH frames instead of one whole-chunk vmap: the
# pair-gathers' packed-u32 tap reads are the program's largest device
# temporaries (4 x u32[T,Hw,Ww], ~14.3 GB at T=768), and XLA's remat
# keeps them alive for the whole chunk.  Mapping in blocks caps the tap
# temporaries at the block size while the warped-channel outputs (u8,
# 2 x T*Hw*Ww) are unchanged.  The threshold leaves the T=512 program
# unblocked.  All three constants were chosen on another device and
# are not yet re-derived for this one.
_WARP_MAP_MIN_T = 768
_WARP_MAP_BATCH = 256
# Chunks below this T warp frame by frame (lax.map with no inner vmap);
# only the T=1 program, where vmap and map were measured to tie, does.
_WARP_VMAP_MIN_T = 2


def _warp_channels_batch(frames, params: TrackerParams):
    """vmap of _warp_channels; frame-by-frame below _WARP_VMAP_MIN_T,
    lax.map'd in blocks at or above _WARP_MAP_MIN_T (see above)."""
    T = frames.shape[0]
    if T < _WARP_VMAP_MIN_T:
        return jax.lax.map(lambda fr: _warp_channels(fr, params), frames)
    f = jax.vmap(lambda fr: _warp_channels(fr, params))
    if T < _WARP_MAP_MIN_T or T % _WARP_MAP_BATCH != 0:
        return f(frames)
    fb = frames.reshape((T // _WARP_MAP_BATCH, _WARP_MAP_BATCH)
                        + frames.shape[1:])
    r, b = jax.lax.map(f, fb)
    return (r.reshape((T,) + r.shape[2:]), b.reshape((T,) + b.shape[2:]))


def _run_attempt(state: TrackerState, cfg: TrackerConfig, scfg, params,
                 ploty_validity, pref: RowPrefixes, iv_sws
                 ) -> AttemptResult:
    """One search+fit+validate attempt (reference find_lane_points + fit +
    check_validity, lane_tracker.py:795-874, 1064-1068).

    Runs entirely on O(H) data: both searches emit per-row x-intervals and
    the fit consumes per-row prefix-sum moments (ops/integrals.py) — the
    exact pixel sets the reference gathers, without touching O(H*W) arrays
    in the sequential path."""
    W, H = params.warped_size
    use_band = state.last_detection <= cfg.n_reset

    def do_band(_):
        return band_intervals(state.last_left, state.last_right, scfg, H, W)

    # The blind sliding-window intervals are state-free and arrive
    # precomputed from the batched front half; only the warm-start band
    # (a function of the carried fit) is computed in the scan.
    iv = jax.lax.cond(use_band, do_band, lambda _: iv_sws, None)
    ln, lsx = interval_moments(pref, iv.left_lo, iv.left_hi, iv.left_valid)
    rn, rsx = interval_moments(pref, iv.right_lo, iv.right_hi, iv.right_valid)
    detected = (ln.sum() > 0) & (rn.sum() > 0)
    # Both sides fit and sample in ONE stacked call: every reduction and
    # the 3x3 solve run once per scan step instead of twice.
    coeffs = fit_poly_rows(
        jnp.stack([ln, rn]), jnp.stack([lsx, rsx]), W
    )
    meta = poly_points_meta(coeffs, ploty_validity, params.warped_size)
    lc, rc = coeffs[0], coeffs[1]
    validity = check_validity(
        lc, rc, meta.n[0], meta.n[1], params.warped_size, cfg.validity
    )
    if params.col_roi is None:
        roi_ok = jnp.bool_(True)
    else:
        # Exactness certificate: every column this attempt READ lies in
        # the corridor.  Interior columns are bit-exact vs 'fast' (the
        # compute margin covers the filter's influence radius), so if
        # all reads are interior the attempt's whole decision trace —
        # window walk, selected pixels, fit, validity — is identical to
        # full-width 'fast' by induction over reads.  Reads are (a) the
        # per-level conv read extents the SWS scan emits (empty for
        # band) and (b) the selected per-row intervals (band reads
        # exactly these; for SWS they are sub-ranges of (a)).
        x0, x1 = params.col_roi

        def _rng_ok(lo, hi, nonempty):
            return jnp.all(jnp.where(nonempty, (lo >= x0) & (hi <= x1),
                                     True))

        roi_ok = (
            _rng_ok(iv.left_read_lo, iv.left_read_hi,
                    iv.left_read_lo < iv.left_read_hi)
            & _rng_ok(iv.right_read_lo, iv.right_read_hi,
                      iv.right_read_lo < iv.right_read_hi)
            & _rng_ok(iv.left_lo, iv.left_hi,
                      iv.left_valid & (iv.left_lo < iv.left_hi))
            & _rng_ok(iv.right_lo, iv.right_hi,
                      iv.right_valid & (iv.right_lo < iv.right_hi))
        )
    return AttemptResult(
        detected=detected,
        valid=detected & validity,
        lc=lc,
        rc=rc,
        search_mode=jnp.where(use_band, jnp.int32(1), jnp.int32(0)),
        n_left=meta.n[0],
        n_right=meta.n[1],
        roi_ok=roi_ok,
    )


def front_half(frame, params: TrackerParams, config: TrackerConfig):
    """Stateless per-frame front half: warp channels + attempt-1 filter.

    Separated out so the chunked pipeline can vmap it over frame
    microbatches while the stateful back half scans (SURVEY §2c).
    """
    r_chan, b_chan = _warp_channels(frame, params)
    f1 = config.filter
    binary1 = filter_lane_points_channels(
        r_chan,
        b_chan,
        filter_type=f1.filter_type,
        ksize_r=f1.ksize_r,
        C_r=f1.C_r,
        ksize_b=f1.ksize_b,
        C_b=f1.C_b,
        mask_noise=f1.mask_noise,
        ksize_noise=f1.ksize_noise,
        C_noise=f1.C_noise,
        noise_thresh=f1.noise_thresh,
        tophat_r=f1.tophat_r,
        tophat_b=f1.tophat_b,
        open_k=f1.open_k,
    )
    return r_chan, b_chan, _embed_cols(binary1, params)


class FrontArtifacts(NamedTuple):
    """Batched per-frame products of the stateless front half."""

    r_chan: jnp.ndarray  # (H, W) u8 warped R channel
    b_chan: jnp.ndarray  # (H, W) u8 warped LAB-B channel
    pref: RowPrefixes  # prefix count/x-sum of the attempt-1 binary
    iv_sws: "SearchIntervals"  # attempt-1 blind-search intervals (state-free)
    pref2: RowPrefixes | None = None  # hoisted attempt-2 binary prefixes
    iv_sws2: "SearchIntervals | None" = None  # hoisted attempt-2 intervals


def _sa_config(params: TrackerParams) -> TrackerConfig:
    """The hardcoded second-attempt parameter set (lane_tracker.py:
    1081-1099), scaled when the warped space is (the 'half' pipeline)."""
    return SECOND_ATTEMPT_HALF if params.res_scale == 2 else SECOND_ATTEMPT


def _second_attempt_binary(r_chan, b_chan, params: TrackerParams):
    """The hardcoded second-attempt filter (lane_tracker.py:1081-1099)."""
    f2 = _sa_config(params).filter
    return filter_lane_points_channels(
        r_chan,
        b_chan,
        filter_type=f2.filter_type,
        ksize_r=f2.ksize_r,
        C_r=f2.C_r,
        ksize_b=f2.ksize_b,
        C_b=f2.C_b,
        mask_noise=f2.mask_noise,
        ksize_noise=f2.ksize_noise,
        C_noise=f2.C_noise,
        noise_thresh=f2.noise_thresh,
        tophat_r=f2.tophat_r,
        tophat_b=f2.tophat_b,
        open_k=f2.open_k,
    )


def _filter_batch(r_chan, b_chan, fcfg):
    """The per-frame XLA filter chain vmapped over a (T, H, W) batch."""
    return jax.vmap(
        lambda r, b: filter_lane_points_channels(
            r, b,
            filter_type=fcfg.filter_type,
            ksize_r=fcfg.ksize_r, C_r=fcfg.C_r,
            ksize_b=fcfg.ksize_b, C_b=fcfg.C_b,
            mask_noise=fcfg.mask_noise, ksize_noise=fcfg.ksize_noise,
            C_noise=fcfg.C_noise, noise_thresh=fcfg.noise_thresh,
            tophat_r=fcfg.tophat_r, tophat_b=fcfg.tophat_b,
            open_k=fcfg.open_k,
        )
    )(r_chan, b_chan)


def second_attempt_artifacts_batch(r_chan, b_chan, params: TrackerParams):
    """Batched attempt-2 front products (state-free): the hardcoded
    'neighborhood' filter (lane_tracker.py:1081-1099) + prefixes + blind
    intervals for a (T, H, W) channel batch."""
    W, H = params.warped_size
    sa = _sa_config(params)
    binary2 = _embed_cols(_filter_batch(r_chan, b_chan, sa.filter), params)
    pref2 = jax.vmap(build_row_prefixes)(binary2)
    iv2 = jax.vmap(lambda b: sliding_window_intervals(
        sws_precompute(b, sa.search),
        sa.search, H, W))(binary2)
    return pref2, iv2


def front_artifacts_batch(
    frames,
    params: TrackerParams,
    config: TrackerConfig,
    hoist_second_attempt: bool = False,
) -> "FrontArtifacts":
    """Batched front half for a (T, Hc, Wc, 3) chunk.

    Same artifacts as vmap(front_artifacts), with the warp blocked by
    chunk size (_warp_channels_batch); bit-identical to the per-frame path.
    """
    r_chan, b_chan = _warp_channels_batch(frames, params)
    binary1 = _embed_cols(_filter_batch(r_chan, b_chan, config.filter),
                          params)
    W, H = params.warped_size
    pref = jax.vmap(build_row_prefixes)(binary1)
    iv_sws = jax.vmap(lambda b: sliding_window_intervals(
        sws_precompute(b, config.search), config.search, H, W))(binary1)
    pref2 = iv2 = None
    if hoist_second_attempt and (config.n_tries >= 2 or config.n_tries == -1):
        pref2, iv2 = second_attempt_artifacts_batch(r_chan, b_chan, params)
    return FrontArtifacts(
        r_chan=r_chan,
        b_chan=b_chan,
        pref=pref,
        iv_sws=iv_sws,
        pref2=pref2,
        iv_sws2=iv2,
    )


def front_artifacts(
    frame,
    params: TrackerParams,
    config: TrackerConfig,
    hoist_second_attempt: bool = False,
):
    """Everything the sequential back half needs, as O(H)-consumable data.

    With ``hoist_second_attempt`` the fallback attempt's filter + precompute
    (the only O(H*W) work of the second attempt) also runs here,
    unconditionally, so the sequential back half contains NO conditional
    O(H*W) work.  That is the batched-fleet configuration (SURVEY §7(e)):
    under vmap a ``lax.cond`` becomes an executed-both-sides select, so the
    conditional re-filter would otherwise run for every frame anyway —
    serially, after the batched front half.
    """
    W, H = params.warped_size
    r_chan, b_chan, binary1 = front_half(frame, params, config)
    pref2 = iv2 = None
    if hoist_second_attempt and (config.n_tries >= 2 or config.n_tries == -1):
        binary2 = _embed_cols(_second_attempt_binary(r_chan, b_chan, params),
                              params)
        sa = _sa_config(params)
        pref2 = build_row_prefixes(binary2)
        iv2 = sliding_window_intervals(
            sws_precompute(binary2, sa.search),
            sa.search, H, W)
    return FrontArtifacts(
        r_chan=r_chan,
        b_chan=b_chan,
        pref=build_row_prefixes(binary1),
        iv_sws=sliding_window_intervals(
            sws_precompute(binary1, config.search), config.search, H, W),
        pref2=pref2,
        iv_sws2=iv2,
    )


class RenderMeta(NamedTuple):
    """Per-frame inputs of the (stateless) overlay renderer."""

    fitx_left: jnp.ndarray  # (H,) f32
    fitx_right: jnp.ndarray
    coeffs_left: jnp.ndarray  # (3,) f32 — smoothed coefficients rendered
    coeffs_right: jnp.ndarray
    n_left: jnp.ndarray
    n_right: jnp.ndarray
    first_left: jnp.ndarray
    first_right: jnp.ndarray
    draw: jnp.ndarray  # () bool


def render_frame(frame, meta: RenderMeta, params: TrackerParams,
                 config: TrackerConfig):
    if params.pipeline != "compat":
        # Direct camera-space evaluation: zero gathers (see render/lane.py).
        W, H = params.warped_size
        partial = config.search.partial
        num = int(H * partial)
        start = H * (1.0 - partial)
        step = ((H - 1.0) - start) / (num - 1) if num > 1 else 1.0
        return lane_overlay_direct(
            frame,
            meta.coeffs_left,
            meta.coeffs_right,
            meta.n_left,
            meta.n_right,
            meta.first_left,
            meta.first_right,
            params.fwd_u,
            params.fwd_v,
            params.warped_size,
            start,
            step,
            meta.draw,
        )
    lane_mask = lane_region_mask(
        params.warped_size,
        meta.fitx_left,
        meta.fitx_right,
        meta.n_left,
        meta.n_right,
        meta.first_left,
        meta.first_right,
    )
    return lane_overlay(frame, lane_mask, params.unwarp_grid, meta.draw)


def back_half(
    state: TrackerState,
    art: "FrontArtifacts",
    params: TrackerParams,
    config: TrackerConfig,
):
    """Sequential back half: search, fit, validate, state update.

    Consumes FrontArtifacts (O(H) prefix/conv tensors); the only O(H*W)
    work left here is the rare second-attempt re-filter inside lax.cond.
    Returns (new_state, StepOutput-without-overlay fields, RenderMeta).
    """
    W, H = params.warped_size
    ploty_validity = ploty_grid(params.warped_size, 1.0)
    ploty_render = ploty_grid(params.warped_size, config.search.partial)

    a1 = _run_attempt(
        state, config, config.search, params, ploty_validity, art.pref,
        art.iv_sws,
    )

    if config.n_tries >= 2 or config.n_tries == -1:
        if art.pref2 is not None:
            # Hoisted mode: the attempt-2 filter ran batched in the front
            # half; the remaining attempt-2 work is O(H), so run it
            # unconditionally and select (vmap-friendly — no cond).
            a2 = _run_attempt(
                state,
                config,
                _sa_config(params).search,
                params,
                ploty_validity,
                art.pref2,
                art.iv_sws2,
            )
            a = jax.tree_util.tree_map(
                lambda x, y: jnp.where(a1.valid, x, y), a1, a2
            )
        else:

            def second(_):
                binary2 = _embed_cols(
                    _second_attempt_binary(art.r_chan, art.b_chan, params),
                    params)
                sa = _sa_config(params)
                return _run_attempt(
                    state,
                    config,
                    sa.search,
                    params,
                    ploty_validity,
                    build_row_prefixes(binary2),
                    sliding_window_intervals(
                        sws_precompute(binary2, sa.search),
                        sa.search, H, W),
                )

            a = jax.lax.cond(a1.valid, lambda _: a1, second, None)
        n_attempts = jnp.where(a1.valid, jnp.int32(1), jnp.int32(2))
    else:
        a = a1
        n_attempts = jnp.int32(1)

    valid = a.valid

    # ---- Rolling history (push on both paths; sentinel = invalid) ----
    new_l = jnp.where(valid, a.lc, jnp.zeros((3,), jnp.float32))
    new_r = jnp.where(valid, a.rc, jnp.zeros((3,), jnp.float32))
    hist_left = jnp.concatenate([state.hist_left[1:], new_l[None, :]], axis=0)
    hist_right = jnp.concatenate([state.hist_right[1:], new_r[None, :]], axis=0)
    hist_valid = jnp.concatenate([state.hist_valid[1:], valid[None]], axis=0)

    last_left = jnp.where(valid, a.lc, state.last_left)
    last_right = jnp.where(valid, a.rc, state.last_right)
    last_detection = jnp.where(valid, jnp.int32(0), state.last_detection + 1)

    # ---- Smoothed coefficients over valid history entries ----
    wv = hist_valid.astype(jnp.float32)
    denom = jnp.maximum(wv.sum(), 1.0)
    avg_left_new = (wv[:, None] * hist_left).sum(axis=0) / denom
    avg_right_new = (wv[:, None] * hist_right).sum(axis=0) / denom
    avg_left = jnp.where(valid, avg_left_new, state.avg_left)
    avg_right = jnp.where(valid, avg_right_new, state.avg_right)
    has_avg = state.has_avg | valid

    # ---- Render geometry from the smoothed fit (success only) ----
    # One stacked sampling call for both sides (see _run_attempt).
    mrender = poly_points_meta(
        jnp.stack([avg_left_new, avg_right_new]), ploty_render,
        params.warped_size,
    )
    ml = jax.tree_util.tree_map(lambda x: x[0], mrender)
    mr = jax.tree_util.tree_map(lambda x: x[1], mrender)
    # State render arrays are padded to H samples so their shape does not
    # depend on config.search.partial (configs may change mid-stream).
    pad = H - ml.fitx.shape[0]
    fitx_l_padded = jnp.pad(ml.fitx, (0, pad))
    fitx_r_padded = jnp.pad(mr.fitx, (0, pad))
    rfitx_left = jnp.where(valid, fitx_l_padded, state.rfitx_left)
    rfitx_right = jnp.where(valid, fitx_r_padded, state.rfitx_right)
    rn_left = jnp.where(valid, ml.n, state.rn_left)
    rn_right = jnp.where(valid, mr.n, state.rn_right)
    rfirst_left = jnp.where(valid, ml.first, state.rfirst_left)
    rfirst_right = jnp.where(valid, mr.first, state.rfirst_right)

    # ---- Curve radius rolling state (lane_tracker.py:530-549, 1148) ----
    rl = curve_radius_m(a.lc, params.warped_size, params.mppv, params.mpph)
    rr = curve_radius_m(a.rc, params.warped_size, params.mppv, params.mpph)
    frame_radius = jnp.trunc(0.5 * (rl + rr))
    radii = jnp.concatenate(
        [state.radii[1:], jnp.where(valid, frame_radius, -1.0)[None]]
    )
    pos = radii > 0
    n_pos = jnp.maximum(pos.sum(), 1)
    avg_radius_new = jnp.trunc((jnp.where(pos, radii, 0.0)).sum() / n_pos)
    avg_radius = jnp.where(valid, avg_radius_new, state.avg_radius)

    # ---- Eccentricity from the bottom-most smoothed graph points ----
    n_samples = ml.fitx.shape[0]
    lb = jnp.trunc(ml.fitx[jnp.clip(ml.first + ml.n - 1, 0, n_samples - 1)])
    rb = jnp.trunc(mr.fitx[jnp.clip(mr.first + mr.n - 1, 0, n_samples - 1)])
    ecc_new = eccentricity_m(lb, rb, params.warped_size, params.mpph)
    ecc = jnp.where(valid, ecc_new, state.ecc)

    new_state = TrackerState(
        last_detection=last_detection,
        hist_left=hist_left,
        hist_right=hist_right,
        hist_valid=hist_valid,
        last_left=last_left,
        last_right=last_right,
        avg_left=avg_left,
        avg_right=avg_right,
        has_avg=has_avg,
        rfitx_left=rfitx_left,
        rfitx_right=rfitx_right,
        rn_left=rn_left,
        rn_right=rn_right,
        rfirst_left=rfirst_left,
        rfirst_right=rfirst_right,
        radii=radii,
        avg_radius=avg_radius,
        ecc=ecc,
        counter=state.counter + 1,
        success=state.success + valid.astype(jnp.int32),
    )

    # ---- Render decision: lane overlay, previous lane during the grace
    # period, or pass-through for the failure message
    # (lane_tracker.py:1160-1173) ----
    draw_lane_now = valid | (state.has_avg & (last_detection <= config.n_fail))
    render_mode = jnp.where(draw_lane_now, jnp.int32(0), jnp.int32(1))
    meta = RenderMeta(
        fitx_left=rfitx_left,
        fitx_right=rfitx_right,
        coeffs_left=avg_left,
        coeffs_right=avg_right,
        n_left=rn_left,
        n_right=rn_right,
        first_left=rfirst_left,
        first_right=rfirst_right,
        draw=draw_lane_now,
    )

    out = StepOutput(
        overlay=None,
        render_mode=render_mode,
        valid=valid,
        detected=a.detected,
        search_mode=a.search_mode,
        n_attempts=n_attempts,
        radius=avg_radius,
        ecc=ecc,
        left_coeffs=a.lc,
        right_coeffs=a.rc,
        n_points_left=a.n_left,
        n_points_right=a.n_right,
        a1_detected=a1.detected,
        a1_valid=a1.valid,
        a1_left_coeffs=a1.lc,
        a1_right_coeffs=a1.rc,
        a1_n_left=a1.n_left,
        a1_n_right=a1.n_right,
        # a1 always executed; `a` is the selected final attempt, whose
        # roi_ok equals a2's exactly when a2 executed (a1 invalid).
        corridor_ok=a1.roi_ok & a.roi_ok,
    )
    return new_state, out, meta


def tracker_step(
    state: TrackerState,
    frame: jnp.ndarray,
    params: TrackerParams,
    config: TrackerConfig,
):
    """Process one frame end to end. Returns (new_state, StepOutput)."""
    art = front_artifacts(frame, params, config)
    new_state, out, meta = back_half(state, art, params, config)
    overlay = render_frame(frame, meta, params, config)
    return new_state, out._replace(overlay=overlay)


@functools.lru_cache(maxsize=32)
def build_step(config: TrackerConfig):
    """jit-compiled step closure for a static config (cached per config)."""

    @jax.jit
    def fn(state, frame, params):
        return tracker_step(state, frame, params, config)

    return fn


def make_initial_state(config: TrackerConfig, warped_size) -> TrackerState:
    # Render arrays are padded to the full warped height regardless of
    # config.search.partial (see tracker_step), so state shape is stable.
    return init_state(config.n_reset, config.n_average, int(warped_size[1]))
