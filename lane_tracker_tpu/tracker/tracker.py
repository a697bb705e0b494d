"""Stateful LaneTracker wrapper with the reference-compatible API.

Drop-in equivalent of the reference ``LaneTracker``
(lane_tracker.py:85-1209): same constructor signature (lane_tracker.py:101),
same ``process()`` keyword surface and defaults (lane_tracker.py:876-900),
same ``get_success_ratio()`` (lane_tracker.py:178-181).  Internally it is a
thin shell: per-call kwargs become a static ``TrackerConfig``, the pure
jitted step runs on device, and host-side post-processing adds the text
annotations (and optional debug visualizations).
"""

from __future__ import annotations

import numpy as np

from lane_tracker_tpu.tracker.config import (
    FilterConfig,
    SearchConfig,
    TrackerConfig,
    ValidityConfig,
    halve_config,
)
from lane_tracker_tpu.tracker.state import TrackerState, state_from_npz, state_to_npz
from lane_tracker_tpu.tracker.step import (
    TrackerParams,
    build_step,
    make_initial_state,
    tracker_step,
)
from lane_tracker_tpu.render.text import draw_text


class LaneTracker:
    """Track the two ego-lane boundary lines across a video stream.

    Args mirror the reference constructor (lane_tracker.py:101-137), plus:
        validity: optional ValidityConfig overriding the committed
            thresholds (the reference hardcodes them; see PRESETS for the
            per-demo-video sets documented in tracker_settings.md).
        pipeline: 'fast' (default; the reference's exact two-stage
            resample chain, ROI-cropped, with the XLA filter chain),
            'corridor' (the benched serving default: 'fast' restricted
            to the decision corridor + its filter-influence margin, with
            a per-frame ``corridor_ok`` certificate under which the
            decision trace is provably bit-identical to 'fast' — content
            escaping the corridor trips the flag instead of silently
            degrading), 'compat' (the chain bit-matching the reference's
            cv2.undistort + cv2.warpPerspective with the XLA filter
            ops), or one of the opt-in MEASURED-APPROXIMATION pipelines
            (quality measured vs the live reference with
            scripts/approx_quality.py): 'half' (the whole warped space at half
            resolution: scaled calibration, doubled m/px, px-denominated
            knobs halved automatically) or 'turbo' (LAB-B computed on
            the undistorted band and warped as a channel instead of
            recomputed on the warped frame).
    """

    def __init__(
        self,
        img_size,
        warped_size,
        cam_matrix,
        dist_coeffs,
        warp_matrices,
        mpp_conversion,
        n_fail=8,
        n_reset=4,
        n_average=2,
        print_frame_count=False,
        validity: ValidityConfig | None = None,
        pipeline: str = "fast",
        latency_mode: bool = False,
    ):
        self.img_size = tuple(int(v) for v in img_size)
        self.warped_size = tuple(int(v) for v in warped_size)
        self.n_fail = int(n_fail)
        self.n_reset = int(n_reset)
        self.n_average = int(n_average)
        self.print_frame_count = bool(print_frame_count)
        self._validity = validity if validity is not None else ValidityConfig()
        self.params = TrackerParams.build(
            np.asarray(cam_matrix, np.float64),
            np.asarray(dist_coeffs, np.float64),
            np.asarray(warp_matrices[0], np.float64),
            np.asarray(warp_matrices[1], np.float64),
            self.img_size,
            self.warped_size,
            float(mpp_conversion[0]),
            float(mpp_conversion[1]),
            pipeline=pipeline,
        )
        if latency_mode:
            # EXPERIMENTAL: swap the per-pixel resampling gathers for the
            # tile-structured slab+one-hot path (bit-identical outputs,
            # kernels/resample_rowmm.py; ~400 MB of device memory).  An
            # opt-in probe surface, not the serving default: whether it
            # beats the gather at T=1 on this device is not measured.
            self.params = self.params.with_rowmm()
        self._state: TrackerState | None = None
        self._prev_state: TrackerState | None = None
        self._chunk_fns = {}  # (config, with_overlay, schedule) -> jitted fn
        self.counter = 0
        self.success = 0
        self.last_output = None  # StepOutput of the most recent frame

    # -- state management ---------------------------------------------------

    def _ensure_state(self, config: TrackerConfig):
        if self._state is None:
            # params.warped_size is the compute-space size ('half' scales
            # it down from the caller's warped_size).
            self._state = make_initial_state(config, self.params.warped_size)

    def reset(self):
        """Forget all tracking state (fresh stream)."""
        self._state = None
        self.counter = 0
        self.success = 0

    def save_state(self, path):
        """Snapshot tracker state for checkpoint/resume."""
        if self._state is None:
            raise RuntimeError("no state to save; process a frame first")
        state_to_npz(self._state, path)

    def load_state(self, path):
        self._state = state_from_npz(path)
        self.counter = int(self._state.counter)
        self.success = int(self._state.success)

    # -- the public API -----------------------------------------------------

    def get_success_ratio(self):
        """Fraction of processed frames with valid lane lines
        (lane_tracker.py:178-181)."""
        return self.success / self.counter, self.success, self.counter

    def _config_from_kwargs(
        self,
        ksize_r,
        C_r,
        ksize_b,
        C_b,
        filter_type,
        mask_noise,
        noise_thresh,
        ksize_noise,
        C_noise,
        window_width,
        window_height,
        search_range,
        mu,
        no_success_limit,
        start_slice,
        ignore_sides,
        ignore_bottom,
        bandwidth,
        partial,
        n_tries,
    ) -> TrackerConfig:
        cfg = TrackerConfig(
            filter=FilterConfig(
                filter_type=filter_type,
                ksize_r=int(ksize_r),
                C_r=int(C_r),
                ksize_b=int(ksize_b),
                C_b=int(C_b),
                mask_noise=bool(mask_noise),
                noise_thresh=int(noise_thresh),
                ksize_noise=int(ksize_noise),
                C_noise=int(C_noise),
            ),
            search=SearchConfig(
                window_width=int(window_width),
                window_height=int(window_height),
                search_range=int(search_range),
                mu=float(mu),
                no_success_limit=int(no_success_limit),
                start_slice=float(start_slice),
                ignore_sides=int(ignore_sides),
                ignore_bottom=int(ignore_bottom),
                bandwidth=int(bandwidth),
                partial=float(partial),
            ),
            validity=self._validity,
            n_tries=int(n_tries),
            n_fail=self.n_fail,
            n_reset=self.n_reset,
            n_average=self.n_average,
        )
        if self.params.res_scale == 2:
            # 'half': the caller speaks full-res px; the compute space is
            # half-res, so px-denominated knobs halve (config.halve_config).
            cfg = halve_config(cfg)
        return cfg

    def _narrate_validity(self, lc, rc, n_left, n_right, v):
        """Print the reference's exact check_validity diagnostics message
        (lane_tracker.py:596-627), recomputed in closed form from the
        fitted coefficients."""
        # Coefficients live in the compute space ('half' scales it down).
        ws = self.params.warped_size
        W = ws[0] if v.y_eval_from_width else ws[1]
        nmin = min(int(n_left), int(n_right))
        y1, y2, y3 = W - 1, W - int(nmin * 0.35), W - int(nmin * 0.75)
        x1, x2, x3 = (
            abs(np.polyval(lc, y) - np.polyval(rc, y)) for y in (y1, y2, y3)
        )
        dist = (
            "x1_diff == {:.2f}, x2_diff == {:.2f}, x3_diff == {:.2f} "
            "(min_dist_y1 == {}, max_dist_y1 == {}, min_dist_y2 == {}, "
            "max_dist_y2 == {}, min_dist_y3 == {}, max_dist_y3 == {})".format(
                x1, x2, x3, v.min_dist_y1, v.max_dist_y1, v.min_dist_y2,
                v.max_dist_y2, v.min_dist_y3, v.max_dist_y3,
            )
        )
        if (
            (x1 < v.min_dist_y1) | (x1 > v.max_dist_y1)
            | (x2 < v.min_dist_y2) | (x2 > v.max_dist_y2)
            | (x3 < v.min_dist_y3) | (x3 > v.max_dist_y3)
        ):
            print(
                "No valid lane lines found, violated distance criterion: "
                + dist
            )
            return
        d = lambda c, y: 2 * c[0] * y + c[1]  # noqa: E731
        norm1 = abs(d(lc, y1) - d(rc, y1))
        norm2 = abs(d(lc, y3) - d(rc, y3))
        tang = "norm1 == {:.3f}, norm2 == {:.3f} (thresh == {})".format(
            norm1, norm2, v.tangent_thresh
        )
        if (norm1 >= v.tangent_thresh) | (norm2 >= v.tangent_thresh):
            print(
                "No valid lane lines found, violated tangent criterion: "
                + tang + ". Distance: " + dist
            )
        else:
            print(
                "Valid lane lines found. Tangents: " + tang
                + ". Distance: " + dist
            )

    def _print_diagnostics(self, out, config):
        """The reference's per-attempt diagnostics narration, reproduced
        print for print (lane_tracker.py:267, 441-447, 461, 596-627,
        1062-1143): search mode, pixel outcome and the validity criterion
        message for EACH attempt that ran, then the attempt verdict."""
        mode = "band" if int(out.search_mode) else "sliding window"
        n_ran = int(out.n_attempts)
        attempts = [(
            bool(out.a1_detected), bool(out.a1_valid),
            np.asarray(out.a1_left_coeffs, float),
            np.asarray(out.a1_right_coeffs, float),
            int(out.a1_n_left), int(out.a1_n_right),
        )]
        if n_ran >= 2:
            attempts.append((
                bool(out.detected), bool(out.valid),
                np.asarray(out.left_coeffs, float),
                np.asarray(out.right_coeffs, float),
                int(out.n_points_left), int(out.n_points_right),
            ))
        for i, (detected, valid, lc, rc, nl, nr) in enumerate(attempts):
            print(f"Using {mode} search.")
            print("Lane pixels found." if detected else "No lane pixels found.")
            if detected:
                self._narrate_validity(lc, rc, nl, nr, config.validity)
            if valid:
                which = "first" if i == 0 else "second"
                print(f"Success at {which} attempt!")
            elif i == 0 and n_ran >= 2:
                print("No success at first attempt, now trying second.")
        if not bool(out.valid):
            print("No success after all attempts.")

    def process(
        self,
        img,
        ksize_r=15,
        C_r=8,
        ksize_b=35,
        C_b=5,
        filter_type="bilateral",
        mask_noise=False,
        noise_thresh=140,
        ksize_noise=65,
        C_noise=10,
        window_width=30,
        window_height=40,
        search_range=20,
        mu=0.1,
        no_success_limit=8,
        start_slice=0.25,
        ignore_sides=360,
        ignore_bottom=30,
        bandwidth=25,
        partial=1.0,
        n_tries=2,
        visualize_search=False,
        split_view=False,
        diagnostics=False,
    ):
        """Process one RGB uint8 frame; returns the annotated frame.

        Mirrors the reference's keyword surface and defaults exactly
        (lane_tracker.py:876-900; per-argument docs there apply verbatim).
        With ``visualize_search`` returns (frame, search_visualization);
        with ``split_view`` returns the 3-pane composite.
        """
        config = self._config_from_kwargs(
            ksize_r, C_r, ksize_b, C_b, filter_type, mask_noise, noise_thresh,
            ksize_noise, C_noise, window_width, window_height, search_range,
            mu, no_success_limit, start_slice, ignore_sides, ignore_bottom,
            bandwidth, partial, n_tries,
        )
        self._ensure_state(config)
        step = build_step(config)
        frame = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
        self._prev_state = self._state
        self._state, out = step(self._state, frame, self.params)
        self.last_output = out
        self.counter += 1
        if bool(out.valid):
            self.success += 1

        if diagnostics:
            self._print_diagnostics(out, config)

        annotated = np.asarray(out.overlay).copy()
        if int(out.render_mode) == 0:
            draw_text(
                annotated, f"Curve Radius: {int(out.radius)} m", (20, 35)
            )
            draw_text(
                annotated, f"Eccentricity: {float(out.ecc):.2f} m", (20, 70)
            )
            if self.print_frame_count:
                draw_text(annotated, f"Frame: {self.counter - 1}", (20, 105))
        else:
            draw_text(annotated, "Lane Line Detection Failed", (20, 35))
            if self.print_frame_count:
                draw_text(annotated, f"Frame: {self.counter - 1}", (20, 70))

        if visualize_search or split_view:
            from lane_tracker_tpu.render.viz import search_visualization

            viz = search_visualization(self, frame, config, out)
            if visualize_search:
                return annotated, viz
            from lane_tracker_tpu.render.split import triple_split_view
            from lane_tracker_tpu.kernels.resample import bilinear_gather

            # The reference always pre-warps the raw frame for the split
            # view (lane_tracker.py:1035).
            warped = np.asarray(bilinear_gather(frame, self.params.grid_warp))
            return triple_split_view([annotated, warped, viz])
        return annotated

    def process_chunk(
        self,
        frames,
        with_overlay=True,
        second_attempt="two_phase",
        **kwargs,
    ):
        """Throughput API: process a (T, H, W, 3) uint8 chunk of consecutive
        frames in one device program.

        Same keyword surface and semantics as :meth:`process` (minus the
        per-frame debug flags ``visualize_search``/``split_view``/
        ``diagnostics``), but the whole chunk runs as one jitted program —
        batched front half, scanned state machine, batched render — so a
        chunk costs ONE host->device round trip instead of T, where
        ``process`` fetches its scalars every frame.  This is the API to
        serve through (see README "Choosing an API").

        ``second_attempt`` selects the fallback schedule ('two_phase' —
        free when every frame tracks — 'cond' or 'hoist'; all three
        bit-identical, see parallel/pipeline.chunk_process).  The
        built processor is memoized per (config, with_overlay, schedule),
        so repeated chunks retrace nothing.

        Returns the chunk's ``StepOutput`` pytree as host arrays with a
        leading T axis (``overlay`` is None when ``with_overlay=False``).
        Text annotations are NOT burned in; render them from the returned
        radius/ecc/render_mode arrays if needed (process_video.py does).
        """
        import inspect

        import jax

        from lane_tracker_tpu.parallel.pipeline import build_chunk_processor

        # The chunk API's tracking defaults ARE process()'s defaults —
        # derive them from its signature so they cannot diverge (minus the
        # per-frame debug flags, which have no chunked equivalent).
        sig = {
            name: p.default
            for name, p in inspect.signature(self.process).parameters.items()
            if p.default is not inspect.Parameter.empty
            and name not in ("visualize_search", "split_view", "diagnostics")
        }
        unknown = set(kwargs) - set(sig)
        if unknown:
            raise TypeError(f"unknown process_chunk kwargs: {sorted(unknown)}")
        sig.update(kwargs)
        config = self._config_from_kwargs(**sig)
        self._ensure_state(config)
        key = (config, bool(with_overlay), str(second_attempt))
        fn = self._chunk_fns.get(key)
        if fn is None:
            fn = self._chunk_fns[key] = build_chunk_processor(
                config, with_overlay=bool(with_overlay),
                second_attempt=str(second_attempt))
        frames = np.ascontiguousarray(np.asarray(frames, dtype=np.uint8))
        if frames.ndim != 4:
            raise ValueError("process_chunk expects a (T, H, W, 3) batch")
        self._prev_state = self._state
        self._state, outs = fn(self._state, frames, self.params)
        valid = np.asarray(outs.valid)
        self.counter += int(valid.shape[0])
        self.success += int(valid.sum())
        self.last_output = jax.tree_util.tree_map(
            lambda x: x[-1] if x is not None else None, outs,
            is_leaf=lambda x: x is None,
        )
        return outs
