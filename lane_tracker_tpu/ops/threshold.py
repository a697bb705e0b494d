"""Adaptive thresholding ops for lane-pixel isolation.

JAX equivalents of the reference's thresholding stage:

* :func:`bilateral_adaptive_threshold` — the cross-kernel threshold the
  reference builds from four ``cv2.filter2D`` passes (lane_tracker.py:14-83).
  A pixel passes iff it is brighter (mode='floor') than the mean of BOTH the
  left and right arms, or BOTH the up and down arms, of a 1-px-thick cross of
  radius ``ksize``, by margin ``C``.  Here each directional sum comes from a
  prefix-sum difference (exact int32), so the whole op is a couple of cumsums
  plus elementwise logic — no convolutions at all.

* :func:`adaptive_mean_threshold` — ``cv2.adaptiveThreshold`` with
  ADAPTIVE_THRESH_MEAN_C / THRESH_BINARY (lane_tracker.py:217-218),
  including OpenCV's replicate-border box mean and its exact uint8 rounding.

* :func:`in_range` — ``cv2.inRange`` for the noise mask
  (lane_tracker.py:223).
"""

from __future__ import annotations

import jax.numpy as jnp


def _shift(x, axis, d):
    """out(i) = x(i + d) along ``axis``, zero-filled out of range."""
    H, W = x.shape
    if d == 0:
        return x
    if abs(d) >= x.shape[axis]:
        return jnp.zeros_like(x)
    if axis == 1:
        pad = jnp.zeros((H, abs(d)), x.dtype)
        return (
            jnp.concatenate([x[:, d:], pad], axis=1)
            if d > 0
            else jnp.concatenate([pad, x[:, :d]], axis=1)
        )
    pad = jnp.zeros((abs(d), W), x.dtype)
    return (
        jnp.concatenate([x[d:, :], pad], axis=0)
        if d > 0
        else jnp.concatenate([pad, x[:d, :]], axis=0)
    )


def _two_arm_sums_i16(x, axis, k):
    """(before, after) sums of the k pixels strictly below/above each
    position along ``axis``; OOB contributes 0.

    Exact int16 (max magnitude 65*255 < 2^15) via binary decomposition of
    ``k`` over a shared doubling aggregate — half the memory traffic of an
    int32 cumsum formulation, which matters because this runs inside the
    hot filter stage.

    The array is left-padded with k zeros so the 'before' arm's aggregate
    reads never fall off the array (partial windows at the border keep
    their in-image contributions; zero-fill shifts handle the right edge).
    """
    n = x.shape[axis]
    if axis == 1:
        x = jnp.concatenate([jnp.zeros((x.shape[0], k), x.dtype), x], axis=1)
    else:
        x = jnp.concatenate([jnp.zeros((k, x.shape[1]), x.dtype), x], axis=0)
    g, glen = x, 1
    before = after = None
    b_off, a_off = -k, 1
    rem = k
    while rem:
        if rem & 1:
            bb = _shift(g, axis, b_off)
            aa = _shift(g, axis, a_off)
            before = bb if before is None else before + bb
            after = aa if after is None else after + aa
            b_off += glen
            a_off += glen
        rem >>= 1
        if rem:
            g = g + _shift(g, axis, glen)
            glen *= 2
    if axis == 1:
        return before[:, k : k + n], after[:, k : k + n]
    return before[k : k + n, :], after[k : k + n, :]


def _directional_sums(img_i16: jnp.ndarray, k: int):
    """Sums of the k pixels strictly left/right/up/down of each pixel.

    Out-of-image pixels contribute 0 (the reference's BORDER_CONSTANT
    zero-padding in its filter2D calls, lane_tracker.py:73-76).
    """
    left, right = _two_arm_sums_i16(img_i16, 1, k)
    up, down = _two_arm_sums_i16(img_i16, 0, k)
    return left, right, up, down


def bilateral_adaptive_threshold(
    img: jnp.ndarray,
    ksize: int = 30,
    C: int = 0,
    mode: str = "floor",
    true_value: int = 255,
    false_value: int = 0,
) -> jnp.ndarray:
    """Cross-kernel adaptive threshold on a single-channel uint8 image.

    Pass condition (mode='floor'): ``sum_left - k*p + C*k < 0`` AND the same
    for the right arm, OR both vertical arms — i.e. the pixel beats the mean
    of both opposing arms by more than C.  Integer-exact parity with the
    reference's int16 filter2D formulation.
    """
    if mode not in ("floor", "ceil"):
        raise ValueError("mode must be 'floor' or 'ceil'")
    k = int(ksize)
    p = img.astype(jnp.int16)
    left, right, up, down = _directional_sums(p, k)
    delta = jnp.int16(C * k) if mode == "floor" else jnp.int16(-C * k)
    kp = jnp.int16(k) * p
    tl = left - kp + delta
    tr = right - kp + delta
    tu = up - kp + delta
    td = down - kp + delta
    if mode == "floor":
        hit = ((tl < 0) & (tr < 0)) | ((tu < 0) & (td < 0))
    else:
        hit = ((tl > 0) & (tr > 0)) | ((tu > 0) & (td > 0))
    return jnp.where(hit, jnp.uint8(true_value), jnp.uint8(false_value))


def _box_mean_replicate_u8(img: jnp.ndarray, k: int) -> jnp.ndarray:
    """Normalized k x k box mean with replicate border, OpenCV-exact rounding.

    Rounds half-to-even like cvRound, implemented in pure integer math.
    """
    r = (k - 1) // 2
    H, W = img.shape
    padded = jnp.pad(img.astype(jnp.int32), ((r, r), (r, r)), mode="edge")
    cs = jnp.cumsum(jnp.cumsum(padded, axis=0), axis=1)
    # Integral image with a zero row/col prepended.
    I = jnp.pad(cs, ((1, 0), (1, 0)))
    s = I[k : k + H, k : k + W] - I[0:H, k : k + W] - I[k : k + H, 0:W] + I[0:H, 0:W]
    area = k * k
    q = s // area
    rem = s - q * area
    twice = 2 * rem
    roundup = (twice > area) | ((twice == area) & (q % 2 == 1))
    return (q + roundup.astype(jnp.int32)).astype(jnp.int32)


def adaptive_mean_threshold(
    img: jnp.ndarray,
    ksize: int,
    C: int,
    max_value: int = 255,
) -> jnp.ndarray:
    """``cv2.adaptiveThreshold(img, max_value, MEAN_C, BINARY, ksize, C)``.

    Threshold: dst = max_value where ``src - mean > -ceil(C)`` else 0.
    The reference calls this with C negated (lane_tracker.py:217-218), i.e.
    pixel must beat the block mean by more than C_r.
    """
    mean = _box_mean_replicate_u8(img, int(ksize))
    # OpenCV: idelta = ceil(C) for THRESH_BINARY; all call sites pass ints.
    idelta = int(C)
    hit = img.astype(jnp.int32) - mean > -idelta
    return jnp.where(hit, jnp.uint8(max_value), jnp.uint8(0))


def in_range(img: jnp.ndarray, lo: int, hi: int) -> jnp.ndarray:
    """``cv2.inRange`` for scalars: 255 where lo <= img <= hi else 0."""
    hit = (img >= jnp.uint8(lo)) & (img <= jnp.uint8(hi))
    return jnp.where(hit, jnp.uint8(255), jnp.uint8(0))
