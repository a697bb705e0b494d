"""Row prefix sums: the bridge between batched filtering and the tiny
sequential tracker state machine.

Both lane-pixel searches ultimately select, per image row, an x-interval
(the sliding window's span or the band around the previous fit), and the
polynomial fit only consumes per-row pixel counts and x-sums
(ops/polyfit.py reduces over rows first).  So the per-frame sequential work
collapses from O(H*W) mask arithmetic to O(H) interval lookups against
prefix sums that are precomputed *batched* for a whole chunk:

    P0[y, x] = #nonzero binary pixels in row y with column < x
    P1[y, x] = sum of their column indices

Interval [lo, hi) then yields count = P0[y,hi]-P0[y,lo] and x-sum =
P1[y,hi]-P1[y,lo] — exactly the moments of the pixel set the reference
gathers with np.nonzero (lane_tracker.py:300, 469), with no data-dependent
shapes.

Both prefixes ride in ONE int32 cumsum: the count needs ceil(log2(W+1))
bits and the x-sum at most 31 - that, so a pixel contributes
``x << SHIFT | 1`` and the packed prefix splits exactly — field
differences over an interval can never borrow (both are non-negative and
bounded).  This halves the cumsum traffic of the hot front half AND the
per-row gathers in the sequential back half.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class RowPrefixes(NamedTuple):
    packed: jnp.ndarray  # (H, W+1) int32 — (x-sum << shift) | count


def _count_shift(W: int) -> int:
    """Bit width of the count field; derived from the static width so it
    never rides in the pytree (W is known from packed.shape at each use)."""
    shift = (W + 1).bit_length()  # counts go up to W inclusive
    # x-sum bound: sum of all column indices of a full row.
    assert (W * (W - 1) // 2) << shift < 2**31, (
        f"packed row prefixes overflow int32 at W={W}"
    )
    return shift


import functools


@functools.lru_cache(maxsize=8)
def _tri_ones_np(W: int):
    """Strictly-lower-triangular ones (W, W+1): T[x', X] = 1 iff x' < X,
    so P = V @ T is the exclusive prefix sum of V along x.  Cached as a
    host array (caching a jnp array would leak tracers under jit)."""
    xs = np.arange(W)[:, None]
    Xs = np.arange(W + 1)[None, :]
    return (xs < Xs).astype(np.float32)


def build_row_prefixes(binary: jnp.ndarray) -> RowPrefixes:
    """Packed prefix count/x-sum per row of a binary (H, W) uint8 image.

    Computed as one bf16 matmul of the stacked (3H, W) count/x-byte
    planes against a shared triangular ones matrix instead of a cumsum
    along x: a log-depth cumsum makes ~11 full passes over the frame,
    while the matmul does the reduction in one.  Which of the two is
    faster on this device is not yet measured.  Exactness: all inputs
    are integers <= 255 (x split into high/low bytes), exactly
    representable in bf16, and the f32 accumulation of <= W such terms
    is exact (< 2^24) — provided the dot accumulates in f32, which
    ``preferred_element_type`` requests.
    """
    H, W = binary.shape
    shift = _count_shift(W)
    tri = jnp.asarray(_tri_ones_np(W), jnp.bfloat16)
    nz = (binary > 0)
    xs = jnp.arange(W, dtype=jnp.int32)[None, :]
    nzb = nz.astype(jnp.bfloat16)
    hi = jnp.where(nz, (xs >> 8), 0).astype(jnp.bfloat16)
    lo = jnp.where(nz, (xs & 0xFF), 0).astype(jnp.bfloat16)
    stacked = jnp.concatenate([nzb, hi, lo], axis=0)  # (3H, W)
    sums = jnp.dot(stacked, tri, preferred_element_type=jnp.float32)
    p0 = sums[:H].astype(jnp.int32)
    p1 = (sums[H:2 * H].astype(jnp.int32) << 8) + sums[2 * H:].astype(jnp.int32)
    packed = (p1 << shift) | p0
    return RowPrefixes(packed=packed)


def row_prefixes_reference(binary) -> np.ndarray:
    """Plain numpy reference of ``build_row_prefixes(binary).packed`` for
    (..., H, W) binaries: the same packing over int64 cumulative sums."""
    nz = (np.asarray(binary) > 0).astype(np.int64)
    W = nz.shape[-1]
    zero = np.zeros(nz.shape[:-1] + (1,), np.int64)
    cnt = np.concatenate([zero, np.cumsum(nz, axis=-1)], axis=-1)
    xsum = np.concatenate(
        [zero, np.cumsum(nz * np.arange(W, dtype=np.int64), axis=-1)],
        axis=-1)
    return (xsum << _count_shift(W)) | cnt


def interval_moments(pref: RowPrefixes, x_lo, x_hi, row_valid):
    """Per-row (count, x-sum) of nonzero pixels with x in [x_lo, x_hi).

    x_lo/x_hi: (H,) int32 (clipped internally); row_valid: (H,) bool.

    The per-row prefix lookups are a mask-and-reduce, not
    ``take_along_axis``: this runs inside the sequential back-half scan,
    where a compare+select+row-reduce fuses into a few elementwise
    passes and a (H, 1) gather does not.
    """
    H, Wp1 = pref.packed.shape
    shift = _count_shift(Wp1 - 1)
    lo = jnp.clip(x_lo, 0, Wp1 - 1)
    hi = jnp.clip(x_hi, 0, Wp1 - 1)
    hi = jnp.maximum(hi, lo)
    cols = jnp.arange(Wp1, dtype=jnp.int32)[None, :]
    wt = (cols == hi[:, None]).astype(jnp.int32) - (
        cols == lo[:, None]
    ).astype(jnp.int32)
    diff = jnp.sum(pref.packed * wt, axis=1)
    n = diff & ((1 << shift) - 1)
    sx = diff >> shift
    valid = row_valid.astype(jnp.int32)
    return n * valid, sx * valid
