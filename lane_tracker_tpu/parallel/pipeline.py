"""Chunked video pipeline: batched front half + scanned back half.

The reference processes frames strictly one at a time through MoviePy
(process_video.py:43), leaving every stage latency-bound.  The tracker's
only *true* sequential dependency is the tiny per-frame state (coefficient
history, counters) feeding the next frame's band search; everything else is
stateless.  So the device pipeline splits each chunk of T frames into:

  1. ``vmap(front_half)``   — undistort+warp gathers, LAB, tophat,
                              thresholds for all T frames at once (the bulk
                              of the arithmetic, batched),
  2. ``lax.scan(back_half)`` — search/fit/validate/state-update per frame
                              (cheap, carries the state),
  3. ``vmap(render_frame)`` — overlay rendering for all T frames at once.

One jit covers all three, so XLA overlaps and fuses across stages.  This is
the single-stream building block; parallel/streams.py shards many of these
across devices.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from lane_tracker_tpu.tracker.config import TrackerConfig
from lane_tracker_tpu.tracker.step import (
    RenderMeta,
    StepOutput,
    TrackerParams,
    back_half,
    front_artifacts_batch,
    render_frame,
    second_attempt_artifacts_batch,
)
from lane_tracker_tpu.tracker.state import TrackerState


def scan_back_half(state, arts, params, config):
    """lax.scan of the sequential back half over a leading-T artifact
    batch. Returns (state, (StepOutput stack, RenderMeta stack))."""

    def body(st, art):
        st, out, meta = back_half(st, art, params, config)
        return st, (out, meta)

    return jax.lax.scan(body, state, arts)


def two_phase_scan(state, arts1, params, config):
    """Conditionally-hoisted second attempt (round-2 verdict item 2).

    Phase 1 scans attempt-1 only (O(H) per frame).  Only if some frame's
    first attempt failed does a chunk-level ``lax.cond`` run the batched
    attempt-2 front (the O(H*W) 'neighborhood' filter — state-free, so
    hoisting is sound) and rescan.  In the steady state (every frame
    valid) the fallback costs NOTHING — unlike the unconditional hoist,
    where every frame pays the attempt-2 filter, and unlike the
    cond-in-scan, which under vmap becomes an executed-both-sides select.

    Bit-exact with both other modes: the phase-1 scan under n_tries=1
    equals the full semantics whenever every frame is attempt-1-valid,
    and the fallback rescans from the ORIGINAL state with the exact
    hoisted artifacts (hoisted == cond is pinned by
    tests/test_parallel.py::test_hoisted_second_attempt_equals_cond).
    """
    cfg1 = dataclasses.replace(config, n_tries=1)
    st1, (outs1, metas1) = scan_back_half(state, arts1, params, cfg1)
    all_valid = outs1.valid.all()

    def keep(_):
        return st1, (outs1, metas1)

    def fallback(_):
        pref2, iv2 = second_attempt_artifacts_batch(
            arts1.r_chan, arts1.b_chan, params)
        full = arts1._replace(pref2=pref2, iv_sws2=iv2)
        return scan_back_half(state, full, params, config)

    return jax.lax.cond(all_valid, keep, fallback, None)


def chunk_process(
    state: TrackerState,
    frames: jnp.ndarray,
    params: TrackerParams,
    config: TrackerConfig,
    with_overlay: bool = True,
    hoist_second_attempt: bool = False,
    second_attempt: str | None = None,
):
    """Process a (T, Hc, Wc, 3) uint8 chunk. Returns (state, outputs).

    outputs is a StepOutput pytree with a leading T axis; ``overlay`` is
    (T, Hc, Wc, 3) when ``with_overlay`` else None.

    ``second_attempt`` selects how the fallback attempt's O(H*W) filter
    is scheduled (all three modes are bit-exact):

    * 'cond' (default) — per-frame ``lax.cond`` inside the scan: only
      invalid frames pay the re-filter, serially.  Best worst-case
      latency for single-stream serving.
    * 'hoist' — unconditional batched attempt-2 front: every frame pays.
      Required when this pipeline is itself vmapped over streams (a
      scanned cond becomes an executed-both-sides select under vmap).
    * 'two_phase' — attempt-1-only scan, then ONE chunk-level cond runs
      the batched attempt-2 front + rescan only when some frame failed.
      Best steady-state throughput; a failure-bearing chunk pays the
      whole batched fallback once.

    ``hoist_second_attempt=True`` is the legacy spelling of 'hoist'.
    """
    mode = second_attempt or ("hoist" if hoist_second_attempt else "cond")
    if mode not in ("cond", "hoist", "two_phase"):
        raise ValueError(f"unknown second_attempt mode {mode!r}")
    has_a2 = config.n_tries >= 2 or config.n_tries == -1
    # Batched front half (bit-identical to the per-frame vmap).
    arts = front_artifacts_batch(
        frames, params, config, hoist_second_attempt=(mode == "hoist")
    )
    if mode == "two_phase" and has_a2:
        state, (outs, metas) = two_phase_scan(state, arts, params, config)
    else:
        state, (outs, metas) = scan_back_half(state, arts, params, config)
    if with_overlay:
        overlays = jax.vmap(
            lambda f, m: render_frame(f, m, params, config)
        )(frames, metas)
        outs = outs._replace(overlay=overlays)
    return state, outs


@functools.lru_cache(maxsize=16)
def build_chunk_processor(
    config: TrackerConfig,
    with_overlay: bool = True,
    hoist_second_attempt: bool = False,
    second_attempt: str | None = None,
):
    """jit-compiled chunk processor for a static config."""

    @jax.jit
    def fn(state, frames, params):
        return chunk_process(
            state, frames, params, config, with_overlay, hoist_second_attempt,
            second_attempt,
        )

    return fn
