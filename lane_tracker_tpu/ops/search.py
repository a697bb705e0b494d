"""Lane-pixel search: sliding-window (blind) and band (warm-start) searches.

JAX re-design of the reference's two search strategies:

* sliding window — lane_tracker.py:242-447.  The reference runs a Python
  loop over ~26 vertical levels, each doing a column-sum, a full-mode
  convolution, a plateau-midpoint argmax restricted to a momentum-adjusted
  search range, and `nonzero` pixel collection.  Here all per-level column
  sums, convolutions, and initial centroids are precomputed in one
  vectorized (batchable) pass (:func:`sws_precompute`), and a `lax.scan`
  carries only the tiny scalar state (centroids, momentum ranges, miss
  counters).

* band search — lane_tracker.py:449-500: a pure function of the previous
  fit and the geometry.

Both searches ultimately select, per image row, an x-INTERVAL (the window's
span or the band around the previous polynomial).  :class:`SearchIntervals`
is therefore the canonical result: O(H) data instead of O(H*W) masks, which
lets the sequential tracker back half run on prefix-sum lookups
(ops/integrals.py) while everything image-sized stays in the batched front
half.  Masks (for visualization, tests, and the standalone API) derive
exactly from the intervals.

Quirk parity notes (verified against the reference's semantics):
  - Window ROI slicing `img[:, c-w:c+w]` uses Python slice semantics: a
    negative start wraps and yields an EMPTY slice, so windows whose left
    edge is negative collect no pixels (lane_tracker.py:299, 371, 409),
    and a negative *stop* in `conv[min:max]` wraps to len(conv)+max
    (lane_tracker.py:358, 398) so heavy negative momentum searches almost
    the full width.
  - Level 0 plateau midpoint uses floor ((a+b)//2, lane_tracker.py:296);
    levels >= 1 use ceil (lane_tracker.py:363, 402).
  - The left side is updated before the right within a level; the right
    side's drift-on-miss reads the left side's CURRENT-level state while
    the left side's reads the right's PREVIOUS-level state
    (lane_tracker.py:385, 423).
  - `int(mu * diff)` truncates toward zero (Python int()).
  - After `no_success_limit` consecutive misses a side stops searching for
    the remainder of the frame (lane_tracker.py:354, 395) and its trailing
    `no_success_limit` centroids are dropped from the visualization list
    (lane_tracker.py:391-392, 429-430).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lane_tracker_tpu.tracker.config import SearchConfig


class SearchIntervals(NamedTuple):
    """Per-row x-intervals [lo, hi) of selected lane pixels, per side."""

    left_lo: jnp.ndarray  # (H,) i32
    left_hi: jnp.ndarray  # (H,) i32
    left_valid: jnp.ndarray  # (H,) bool
    right_lo: jnp.ndarray
    right_hi: jnp.ndarray
    right_valid: jnp.ndarray
    # Visualization bookkeeping (sliding-window only; zeros for band):
    left_centroids: jnp.ndarray  # (nlevels,) i32
    right_centroids: jnp.ndarray
    left_n_centroids: jnp.ndarray  # () i32 — list length after trailing drops
    right_n_centroids: jnp.ndarray
    # Binary columns [lo, hi) each level's conv reads touched (sliding
    # window only; empty for band, whose reads ARE the row intervals).
    # Consumed by the 'corridor' exactness certificate.
    left_read_lo: jnp.ndarray = None  # (nlevels,) i32
    left_read_hi: jnp.ndarray = None
    right_read_lo: jnp.ndarray = None
    right_read_hi: jnp.ndarray = None


class SearchResult(NamedTuple):
    left_mask: jnp.ndarray  # (H, W) bool — selected left lane pixels
    right_mask: jnp.ndarray  # (H, W) bool
    detected: jnp.ndarray  # () bool — both sides collected >= 1 pixel
    left_centroids: jnp.ndarray
    right_centroids: jnp.ndarray
    left_n_centroids: jnp.ndarray
    right_n_centroids: jnp.ndarray


class SwsPrecomp(NamedTuple):
    """State-independent sliding-window tensors (batchable per chunk)."""

    left_c0: jnp.ndarray  # () i32 — initial centroid
    left_found0: jnp.ndarray  # () bool
    right_c0: jnp.ndarray
    right_found0: jnp.ndarray
    conv_all: jnp.ndarray  # (nlevels, W+ww-1) i32 — per-level convolutions


def _plateau_mid(vals, ceil_mode):
    """Midpoint of the argmax plateau (reference's argpartition trick,
    lane_tracker.py:294-296); masked entries must be < 0."""
    n = vals.shape[0]
    m = jnp.max(vals)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    is_max = vals == m
    first = jnp.min(jnp.where(is_max, idx, n))
    last = jnp.max(jnp.where(is_max, idx, -1))
    if ceil_mode:
        return (first + last + 1) // 2
    return (first + last) // 2


def _full_conv_ones(sm, window_width):
    """np.convolve(ones(window_width), sm) for a batch of rows (int32)."""
    L, W = sm.shape
    ww = window_width
    cs = jnp.cumsum(sm, axis=1)
    total = W + ww - 1
    idx_hi = jnp.clip(jnp.arange(total), 0, W - 1)
    idx_lo = jnp.arange(total) - ww
    hi = jnp.take(cs, idx_hi, axis=1)
    lo = jnp.where(
        idx_lo < 0,
        jnp.zeros((L, total), cs.dtype),
        jnp.take(cs, jnp.clip(idx_lo, 0, W - 1), axis=1),
    )
    return hi - lo


def _initial_centroid(conv, any_input, offset, fallback, window_width):
    found = any_input
    mid = _plateau_mid(jnp.where(found, conv, -1), ceil_mode=False)
    centroid = mid - window_width // 2 + offset
    return jnp.where(found, centroid, fallback).astype(jnp.int32), found


def sws_nlevels(cfg: SearchConfig, H: int) -> int:
    return int((cfg.partial * (H - cfg.ignore_bottom)) / cfg.window_height)


def sws_precompute(binary: jnp.ndarray, cfg: SearchConfig) -> SwsPrecomp:
    """All state-independent sliding-window tensors for one frame.

    Pure function of the binary image — vmap it over a chunk so the scan
    body only runs the scalar centroid state machine.
    """
    H, W = binary.shape
    ww = int(cfg.window_width)
    wh = int(cfg.window_height)
    ignore_bottom = int(cfg.ignore_bottom)
    ignore_sides = int(cfg.ignore_sides)
    img_height = H - ignore_bottom
    img_center = W // 2
    y_start = int((1 - cfg.start_slice) * img_height)
    nlevels = sws_nlevels(cfg, H)

    # Stage the 0/1 image in int8, accumulating reductions in int32 via
    # the reduce's dtype: under a chunk-wide vmap the staged image is the
    # program's largest temp (XLA materializes it for the two consumers
    # below), and int8 prices it at 1 byte/px instead of the s32 cast's 4
    # — enough to decide whether a T=768 chunk fits in device memory.
    # Exact: values are 0/1, every sum here is < 2^24.
    img = (binary > 0).astype(jnp.int8)

    col_sum = jnp.sum(img[y_start:img_height, :], axis=0, dtype=jnp.int32)
    # The reference convolves the *sliced* arrays; emulate with static
    # slices so conv indices match its coordinate frame.  Empty slices
    # (tiny geometries) fall through to the fallback centroid like the
    # reference's np.any() on an empty array.
    if img_center - ignore_sides > 0:
        lslice = col_sum[ignore_sides:img_center]
        conv_l0 = _full_conv_ones(lslice[None, :], ww)[0]
        left_c0, left_found0 = _initial_centroid(
            conv_l0, jnp.any(lslice > 0), ignore_sides, int(W * 0.4), ww
        )
    else:
        left_c0 = jnp.int32(int(W * 0.4))
        left_found0 = jnp.bool_(False)
    if (W - ignore_sides) - img_center > 0:
        rslice = col_sum[img_center : W - ignore_sides]
        conv_r0 = _full_conv_ones(rslice[None, :], ww)[0]
        right_c0, right_found0 = _initial_centroid(
            conv_r0, jnp.any(rslice > 0), img_center, int(W * 0.6), ww
        )
    else:
        right_c0 = jnp.int32(int(W * 0.6))
        right_found0 = jnp.bool_(False)

    # Level l covers rows [img_height-(1+l)*wh, img_height-l*wh).
    n_eff = max(nlevels, 1)
    flipped = img[:img_height][::-1]
    usable = min(n_eff * wh, img_height)
    bands = jnp.zeros((n_eff, wh, W), jnp.int8)
    bands = bands.at[: usable // wh].set(
        flipped[: (usable // wh) * wh].reshape(usable // wh, wh, W)
    )
    conv_all = _full_conv_ones(bands.sum(axis=1, dtype=jnp.int32), ww)
    return SwsPrecomp(
        left_c0=left_c0,
        left_found0=left_found0,
        right_c0=right_c0,
        right_found0=right_found0,
        conv_all=conv_all,
    )


class _Carry(NamedTuple):
    lc: jnp.ndarray
    rc: jnp.ndarray
    lns: jnp.ndarray  # left no-success count
    rns: jnp.ndarray
    lrmin: jnp.ndarray  # momentum-adjusted search ranges
    lrmax: jnp.ndarray
    rrmin: jnp.ndarray
    rrmax: jnp.ndarray
    ldiff: jnp.ndarray  # last successful centroid delta
    rdiff: jnp.ndarray
    lhas_diff: jnp.ndarray
    rhas_diff: jnp.ndarray


def sliding_window_intervals(
    pre: SwsPrecomp, cfg: SearchConfig, H: int, W: int
) -> SearchIntervals:
    """Run the sequential centroid state machine; emit per-row intervals."""
    ww = int(cfg.window_width)
    wh = int(cfg.window_height)
    w2 = ww // 2
    ignore_bottom = int(cfg.ignore_bottom)
    img_height = H - ignore_bottom
    nlevels = sws_nlevels(cfg, H)
    limit = int(cfg.no_success_limit)
    mu = float(cfg.mu)
    sr = int(cfg.search_range)
    conv_len = W + ww - 1
    conv_idx = jnp.arange(conv_len)

    def side_update(conv, c, ns, rmin, rmax, diff, has_diff, other_diff,
                    other_has_diff, other_ns):
        active = ns < limit
        min_index = jnp.maximum(c + rmin + w2, 0)
        max_index = jnp.minimum(c + rmax + w2, W)
        # Negative-stop Python slice wraparound quirk.
        max_index = jnp.where(max_index < 0, conv_len + max_index, max_index)
        in_range = (conv_idx >= min_index) & (conv_idx < max_index)
        vals = jnp.where(in_range, conv, 0)
        found = active & jnp.any(vals > 0)
        rel = jnp.where(in_range, conv, -1)
        m = jnp.max(rel)
        is_max = (rel == m) & in_range
        first = jnp.min(jnp.where(is_max, conv_idx, conv_len)) - min_index
        last = jnp.max(jnp.where(is_max, conv_idx, -1)) - min_index
        mid = (first + last + 1) // 2
        new_c_found = mid + min_index - w2
        step = jnp.trunc(mu * (new_c_found - c).astype(jnp.float32)).astype(jnp.int32)
        drift = jnp.where(active & other_has_diff & (other_ns == 0), other_diff, 0)
        new_c = jnp.where(found, new_c_found, c + jnp.where(found, 0, drift))
        new_ns = jnp.where(found, 0, jnp.where(active, ns + 1, ns))
        new_rmin = jnp.where(found, rmin + step, rmin)
        new_rmax = jnp.where(found, rmax + step, rmax)
        new_diff = jnp.where(found, new_c_found - c, diff)
        new_has = has_diff | found
        # Binary columns this level's conv reads actually touched (conv
        # index p aggregates columns [p-ww+1, p]); inactive levels read
        # nothing decision-relevant (found is forced False and the
        # centroid evolves by drift alone), so they report empty.  Used
        # by the 'corridor' pipeline's exactness certificate
        # (tracker/step._run_attempt): if every read of every executed
        # attempt stayed inside the corridor, the frame's whole decision
        # trace is bit-identical to full-width 'fast' by induction.
        rd_lo = jnp.where(active, jnp.clip(min_index - (ww - 1), 0, W), W)
        rd_hi = jnp.where(active, jnp.clip(max_index, 0, W), 0)
        return (new_c, new_ns, new_rmin, new_rmax, new_diff, new_has,
                found, active, rd_lo, rd_hi)

    def body(carry: _Carry, conv):
        (lc, lns, lrmin, lrmax, ldiff, lhas, lfound, lactive,
         lrd_lo, lrd_hi) = side_update(
            conv, carry.lc, carry.lns, carry.lrmin, carry.lrmax, carry.ldiff,
            carry.lhas_diff, carry.rdiff, carry.rhas_diff, carry.rns,
        )
        # Right side sees the left side's CURRENT-level state.
        (rc, rns, rrmin, rrmax, rdiff, rhas, rfound, ractive,
         rrd_lo, rrd_hi) = side_update(
            conv, carry.rc, carry.rns, carry.rrmin, carry.rrmax, carry.rdiff,
            carry.rhas_diff, ldiff, lhas, lns,
        )
        new = _Carry(lc, rc, lns, rns, lrmin, lrmax, rrmin, rrmax,
                     ldiff, rdiff, lhas, rhas)
        return new, (lfound, lc, lactive, rfound, rc, ractive,
                     lrd_lo, lrd_hi, rrd_lo, rrd_hi)

    init = _Carry(
        lc=pre.left_c0,
        rc=pre.right_c0,
        lns=jnp.int32(0),
        rns=jnp.int32(0),
        lrmin=jnp.int32(-sr),
        lrmax=jnp.int32(sr),
        rrmin=jnp.int32(-sr),
        rrmax=jnp.int32(sr),
        ldiff=jnp.int32(0),
        rdiff=jnp.int32(0),
        lhas_diff=jnp.bool_(False),
        rhas_diff=jnp.bool_(False),
    )
    one_true = jnp.ones((1,), jnp.bool_)
    # Level-0 (seed) reads are the static histogram slices
    # (sws_precompute: col_sum/conv over [ignore_sides, img_center) and
    # [img_center, W - ignore_sides)); degenerate slices read nothing.
    ignore_sides = int(cfg.ignore_sides)
    img_center = W // 2
    l0 = ((jnp.asarray([ignore_sides]), jnp.asarray([img_center]))
          if img_center - ignore_sides > 0
          else (jnp.asarray([W]), jnp.asarray([0])))
    r0 = ((jnp.asarray([img_center]), jnp.asarray([W - ignore_sides]))
          if (W - ignore_sides) - img_center > 0
          else (jnp.asarray([W]), jnp.asarray([0])))
    if nlevels > 1:
        _, (lfound, lcent, lactive, rfound, rcent, ractive,
            lrd_lo, lrd_hi, rrd_lo, rrd_hi) = jax.lax.scan(
            body, init, pre.conv_all[1:nlevels]
        )
        lfound = jnp.concatenate([pre.left_found0[None], lfound])
        lcent = jnp.concatenate([pre.left_c0[None], lcent])
        lactive = jnp.concatenate([one_true, lactive])
        rfound = jnp.concatenate([pre.right_found0[None], rfound])
        rcent = jnp.concatenate([pre.right_c0[None], rcent])
        ractive = jnp.concatenate([one_true, ractive])
        lrd_lo = jnp.concatenate([l0[0], lrd_lo])
        lrd_hi = jnp.concatenate([l0[1], lrd_hi])
        rrd_lo = jnp.concatenate([r0[0], rrd_lo])
        rrd_hi = jnp.concatenate([r0[1], rrd_hi])
    else:
        lfound = pre.left_found0[None]
        lcent = pre.left_c0[None]
        lactive = one_true
        rfound = pre.right_found0[None]
        rcent = pre.right_c0[None]
        ractive = one_true
        lrd_lo, lrd_hi = l0
        rrd_lo, rrd_hi = r0

    # ---- Per-row intervals from per-level window decisions ----
    ys = jnp.arange(H)
    n_mask_levels = max(nlevels, 1)  # level 0 (initial window) always exists
    level_of_row = (img_height - 1 - ys) // wh
    row_valid = (
        (ys < img_height) & (level_of_row >= 0) & (level_of_row < n_mask_levels)
    )
    lvl = jnp.clip(level_of_row, 0, n_mask_levels - 1)

    def side_intervals(found, cent):
        c_r = jnp.take(cent, lvl)
        f_r = jnp.take(found, lvl) & row_valid
        x_lo = c_r - w2
        x_hi = jnp.minimum(c_r + w2, W)
        # Python-slice-wrap quirk: negative window start -> empty window.
        f_r = f_r & (x_lo >= 0)
        return x_lo, x_hi, f_r

    llo, lhi, lval = side_intervals(lfound, lcent)
    rlo, rhi, rval = side_intervals(rfound, rcent)

    def n_centroids(active):
        appended = jnp.sum(active.astype(jnp.int32))
        aborted = jnp.any(~active)
        return jnp.where(aborted, appended - limit, appended)

    return SearchIntervals(
        left_lo=llo,
        left_hi=lhi,
        left_valid=lval,
        right_lo=rlo,
        right_hi=rhi,
        right_valid=rval,
        left_centroids=lcent,
        right_centroids=rcent,
        left_n_centroids=n_centroids(lactive),
        right_n_centroids=n_centroids(ractive),
        left_read_lo=lrd_lo.astype(jnp.int32),
        left_read_hi=lrd_hi.astype(jnp.int32),
        right_read_lo=rrd_lo.astype(jnp.int32),
        right_read_hi=rrd_hi.astype(jnp.int32),
    )


def band_intervals(
    left_coeffs, right_coeffs, cfg: SearchConfig, H: int, W: int
) -> SearchIntervals:
    """Warm-start band intervals around the previous fit
    (lane_tracker.py:449-500): integer x with poly-bw < x < poly+bw.

    Pure function of the previous coefficients — no image access at all.
    """
    bw = float(cfg.bandwidth)
    ignore_bottom = int(cfg.ignore_bottom)
    # 2017-NumPy truncation semantics for the partial crop
    # (lane_tracker.py:465-466).
    top_cut = int(H * (1 - cfg.partial))
    ys = jnp.arange(H, dtype=jnp.float32)
    row_ok = (jnp.arange(H) >= top_cut) & (jnp.arange(H) < H - ignore_bottom)

    def side(coeffs):
        c = coeffs.astype(jnp.float32)
        px = c[0] * ys * ys + c[1] * ys + c[2]
        # x > px-bw  <=>  x >= floor(px-bw)+1 ; x < px+bw <=> x <= ceil(px+bw)-1
        lo = jnp.floor(px - bw).astype(jnp.int32) + 1
        hi = jnp.ceil(px + bw).astype(jnp.int32)  # exclusive
        return jnp.clip(lo, 0, W), jnp.clip(hi, 0, W)

    llo, lhi = side(left_coeffs)
    rlo, rhi = side(right_coeffs)
    nlevels = max(sws_nlevels(cfg, H), 1)
    zeros = jnp.zeros((nlevels,), jnp.int32)
    return SearchIntervals(
        left_lo=llo,
        left_hi=lhi,
        left_valid=row_ok,
        right_lo=rlo,
        right_hi=rhi,
        right_valid=row_ok,
        left_centroids=zeros,
        right_centroids=zeros,
        left_n_centroids=jnp.int32(0),
        right_n_centroids=jnp.int32(0),
        # Band reads exactly its row intervals; no level reads.
        left_read_lo=jnp.full((nlevels,), W, jnp.int32),
        left_read_hi=zeros,
        right_read_lo=jnp.full((nlevels,), W, jnp.int32),
        right_read_hi=zeros,
    )


def intervals_to_masks(binary: jnp.ndarray, iv: SearchIntervals):
    """Exact pixel masks from per-row intervals (viz/tests/standalone API)."""
    nz = binary > 0
    xs = jnp.arange(binary.shape[1])[None, :]

    def side(lo, hi, valid):
        return (
            nz
            & valid[:, None]
            & (xs >= lo[:, None])
            & (xs < hi[:, None])
        )

    return (
        side(iv.left_lo, iv.left_hi, iv.left_valid),
        side(iv.right_lo, iv.right_hi, iv.right_valid),
    )


def _result_from_intervals(binary, iv: SearchIntervals) -> SearchResult:
    left_mask, right_mask = intervals_to_masks(binary, iv)
    return SearchResult(
        left_mask=left_mask,
        right_mask=right_mask,
        detected=jnp.any(left_mask) & jnp.any(right_mask),
        left_centroids=iv.left_centroids,
        right_centroids=iv.right_centroids,
        left_n_centroids=iv.left_n_centroids,
        right_n_centroids=iv.right_n_centroids,
    )


def sliding_window_search(binary: jnp.ndarray, cfg: SearchConfig) -> SearchResult:
    """Blind sliding-window search (standalone mask API)."""
    H, W = binary.shape
    pre = sws_precompute(binary, cfg)
    iv = sliding_window_intervals(pre, cfg, H, W)
    return _result_from_intervals(binary, iv)


def band_search(
    binary: jnp.ndarray, left_coeffs, right_coeffs, cfg: SearchConfig
) -> SearchResult:
    """Warm-start band search (standalone mask API)."""
    H, W = binary.shape
    iv = band_intervals(left_coeffs, right_coeffs, cfg, H, W)
    return _result_from_intervals(binary, iv)
