"""Grayscale morphology with elliptical structuring elements.

The reference's filter stage leans on ``cv2.morphologyEx``: tophat with
29x29 / 55x55 ellipses and open with a 5x5 ellipse (lane_tracker.py:203-211,
238).  A naive 55x55 window is ~3000 taps per pixel; here the elliptical SE
is decomposed into one horizontal run per SE row, each run computed as a
centered min/max filter via log-depth doubling, then combined across rows.
Cost: O(#distinct run lengths * log(width) + SE height) elementwise passes —
about 100 elementwise passes instead of 3000 taps, all fusable by XLA.

Border semantics match OpenCV's default morphologyEx border
(BORDER_CONSTANT with +inf for erode / -inf for dilate): out-of-bounds
pixels never win the min/max, implemented by padding with 255 / 0.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def ellipse_runs(ksize: int):
    """Per-row horizontal runs of OpenCV's MORPH_ELLIPSE structuring element.

    Replicates cv2.getStructuringElement's ellipse rasterization (including
    its round-half-even saturate_cast) so the SE footprint is identical.

    Returns:
        Tuple of (dy, half_width) pairs: for SE row at vertical offset ``dy``
        from the anchor, the run spans horizontal offsets
        [-half_width, +half_width].
    """
    if ksize < 1:
        raise ValueError("ksize must be >= 1")
    r = ksize // 2
    c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    runs = []
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r and r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, ksize)
            runs.append((dy, (j1 - c, j2 - 1 - c)))
        elif r == 0:
            runs.append((0, (0, 0)))
    return tuple(runs)


def _shift2d(img, dy, dx, fill):
    """Shift so that out(y, x) = img(y + dy, x + dx), padding with ``fill``."""
    H, W = img.shape
    out = img
    if dx:
        pad = jnp.full((H, abs(dx)), fill, img.dtype)
        if dx > 0:
            out = jnp.concatenate([out[:, dx:], pad], axis=1)
        else:
            out = jnp.concatenate([pad, out[:, :dx]], axis=1)
    if dy:
        pad = jnp.full((abs(dy), W), fill, img.dtype)
        if dy > 0:
            out = jnp.concatenate([out[dy:, :], pad], axis=0)
        else:
            out = jnp.concatenate([pad, out[:dy, :]], axis=0)
    return out


class _WindowPyramid:
    """Shared pow2 window aggregates along one axis.

    Builds g_k(x) = op(P[x .. x+2^k-1]) once on a padded array; any window
    [lo, hi] (relative offsets, |lo|,hi <= pad) is then two overlapping
    pow2 windows — one extra op per distinct window instead of a full
    doubling chain each.  min/max are idempotent, so overlap is safe.
    """

    def __init__(self, img, axis, op, fill, pad, max_len):
        self.axis = axis
        self.op = op
        self.n = img.shape[axis]
        self.pad = pad
        padw = [(0, 0), (0, 0)]
        padw[axis] = (pad, pad)
        P = jnp.pad(img, padw, constant_values=fill)
        self.levels = [P]
        length = 1
        while length * 2 <= max_len:
            g = self.levels[-1]
            self.levels.append(op(g, self._sh(g, length)))
            length *= 2

    def _sh(self, a, d):
        # Rotate toward lower indices; wrapped tail values are never read
        # because all pyramid reads stay within the padded valid extent.
        if self.axis == 0:
            return jnp.concatenate([a[d:, :], a[:d, :]], axis=0)
        return jnp.concatenate([a[:, d:], a[:, :d]], axis=1)

    def window(self, lo, hi):
        """op over offsets [lo, hi] for every valid position (length n)."""
        L = hi - lo + 1
        k = L.bit_length() - 1
        p = 1 << k

        def sl(a, start):
            idx = [slice(None), slice(None)]
            idx[self.axis] = slice(start, start + self.n)
            return a[tuple(idx)]

        g = self.levels[k]
        if p == L:
            return sl(g, self.pad + lo)
        return self.op(sl(g, self.pad + lo), sl(g, self.pad + hi - p + 1))


def _morph(img, ksize, op, fill):
    runs = ellipse_runs(ksize)
    c = ksize // 2
    by_extent = {}
    for dy, ext in runs:
        by_extent.setdefault(ext, []).append(dy)
    max_run = max(hi - lo + 1 for (lo, hi) in by_extent)
    hpyr = _WindowPyramid(img, axis=1, op=op, fill=fill, pad=c, max_len=max_run)

    out = None
    for ext, dys in sorted(by_extent.items()):
        h = hpyr.window(ext[0], ext[1])
        # Contiguous dy spans of this extent combine via one vertical window.
        dys = sorted(dys)
        segments = []
        start = prev = dys[0]
        for d in dys[1:]:
            if d == prev + 1:
                prev = d
            else:
                segments.append((start, prev))
                start = prev = d
        segments.append((start, prev))
        max_span = max(hi - lo + 1 for lo, hi in segments)
        vpyr = _WindowPyramid(h, axis=0, op=op, fill=fill, pad=c, max_len=max_span)
        for lo, hi in segments:
            seg = vpyr.window(lo, hi)
            out = seg if out is None else op(out, seg)
    return out


def erode_ellipse(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Grayscale erosion with a ksize x ksize elliptical SE (uint8)."""
    return _morph(img, ksize, jnp.minimum, jnp.uint8(255))


def dilate_ellipse(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Grayscale dilation with a ksize x ksize elliptical SE (uint8)."""
    return _morph(img, ksize, jnp.maximum, jnp.uint8(0))


def open_ellipse(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Morphological opening (erode then dilate), as in lane_tracker.py:238."""
    return dilate_ellipse(erode_ellipse(img, ksize), ksize)


def tophat_ellipse(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """White tophat: img - open(img), as in lane_tracker.py:210-211."""
    return img - open_ellipse(img, ksize)
