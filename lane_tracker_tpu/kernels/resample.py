"""Bilinear gather resampling on device.

This is the device replacement for every per-frame OpenCV resampling in
the reference: ``cv2.undistort`` (lane_tracker.py:832), the bird's-eye
``cv2.warpPerspective`` (lane_tracker.py:834, 1035) and the overlay unwarp
(lane_tracker.py:650).  The host precomputes a sampling grid once
(lane_tracker_tpu.calib); at runtime a frame costs exactly ONE gather:

The four bilinear taps are packed into a single uint32 word per source
pixel (the 2x2 neighborhood packed as bytes via three shifted ORs) and
fetched with one ``jnp.take``, so a frame costs one gathered index per
destination pixel instead of four.  At image borders the 2x2 packing
window is clipped inward and the host remaps each in-bounds tap's weight
onto the matching window slot, so results stay bit-identical to the
four-tap formulation.  The layout was chosen on another device; whether
it beats a plain four-tap gather on this one is not yet measured.

Arithmetic matches OpenCV: 'fixed' grids reproduce the classic fixed-point
remap (1/32-px coordinates, 2^15 weights, round-half-up) bit-for-bit —
``cv2.undistort`` parity; 'float' grids reproduce OpenCV >= 5's float-path
``warpPerspective`` to <=1 intensity unit on <0.05% of pixels.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

COEF_BITS = 15
_ROUND = 1 << (COEF_BITS - 1)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ResampleGrid:
    """Device-resident packed sampling grid.

    Layout (all (H, W) of the *destination* image):
        base: int32 flattened source index of the packing window's top-left
              corner (clipped to [0, H-2] x [0, W-2] so the 2x2 window is
              always fully inside the source image)
        w00..w11: window-slot weights (int32 for fixed grids, float32 for
              float grids); out-of-bounds taps carry weight 0 and border
              taps are remapped onto their clipped window slot.
    """

    base: jnp.ndarray
    w00: jnp.ndarray
    w01: jnp.ndarray
    w10: jnp.ndarray
    w11: jnp.ndarray
    src_size: tuple  # (W, H) static

    def tree_flatten(self):
        return (self.base, self.w00, self.w01, self.w10, self.w11), self.src_size

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, src_size=aux)

    @classmethod
    def from_quantized(cls, grid: dict) -> "ResampleGrid":
        """Build from the host-side dict produced by calib quantizers."""
        src_w, src_h = grid["src_size"]
        ix = grid["ix"].astype(np.int64)
        iy = grid["iy"].astype(np.int64)
        bx = np.clip(ix, 0, src_w - 2)
        by = np.clip(iy, 0, src_h - 2)
        wdtype = grid["w00"].dtype
        pw = {
            (0, 0): np.zeros(ix.shape, wdtype),
            (0, 1): np.zeros(ix.shape, wdtype),
            (1, 0): np.zeros(ix.shape, wdtype),
            (1, 1): np.zeros(ix.shape, wdtype),
        }
        for (dy, dx), key in (((0, 0), "w00"), ((0, 1), "w01"),
                              ((1, 0), "w10"), ((1, 1), "w11")):
            ty = iy + dy
            tx = ix + dx
            inb = (tx >= 0) & (tx < src_w) & (ty >= 0) & (ty < src_h)
            sy = ty - by  # in-bounds taps land within the clipped window
            sx = tx - bx
            for slot in ((0, 0), (0, 1), (1, 0), (1, 1)):
                hit = inb & (sy == slot[0]) & (sx == slot[1])
                pw[slot] = pw[slot] + np.where(hit, grid[key], 0).astype(wdtype)
        base = (by * src_w + bx).astype(np.int32)
        return cls(
            jnp.asarray(base),
            jnp.asarray(pw[(0, 0)]),
            jnp.asarray(pw[(0, 1)]),
            jnp.asarray(pw[(1, 0)]),
            jnp.asarray(pw[(1, 1)]),
            src_size=(int(src_w), int(src_h)),
        )

    @property
    def dst_shape(self):
        return self.base.shape


def combine_taps(p00, p01, p10, p11, grid: "ResampleGrid", bias=None):
    """Weighted bilinear combine of the four window-slot taps — THE single
    arithmetic definition shared by every resampling path (per-pixel
    gathers here, row-matmul taps in resample_rowmm.py), so alternative
    tap-fetch strategies are bit-identical by construction.

    Float grids: f32 weights, round-half-even (OpenCV >= 5 float path).
    Fixed grids: 2^15 int weights, round-half-up (classic OpenCV remap).
    """
    if grid.w00.dtype == jnp.float32:
        acc = (
            p00.astype(jnp.float32) * grid.w00
            + p01.astype(jnp.float32) * grid.w01
            + p10.astype(jnp.float32) * grid.w10
            + p11.astype(jnp.float32) * grid.w11
        )
        if bias is not None:
            acc = acc + bias
        return jnp.clip(jnp.rint(acc), 0, 255).astype(jnp.uint8)
    if bias is not None:
        raise NotImplementedError("bias is only supported on float-weight grids")
    acc = (
        p00.astype(jnp.int32) * grid.w00
        + p01.astype(jnp.int32) * grid.w01
        + p10.astype(jnp.int32) * grid.w10
        + p11.astype(jnp.int32) * grid.w11
    )
    return jnp.clip((acc + _ROUND) >> COEF_BITS, 0, 255).astype(jnp.uint8)


def _pack_2x2(img: jnp.ndarray) -> jnp.ndarray:
    """uint32 image whose word at (y, x) packs the 2x2 neighborhood
    [img[y,x], img[y,x+1], img[y+1,x], img[y+1,x+1]] as bytes."""
    H, W = img.shape
    x = img.astype(jnp.uint32)
    right = jnp.concatenate([x[:, 1:], jnp.zeros((H, 1), jnp.uint32)], axis=1)
    down = jnp.concatenate([x[1:, :], jnp.zeros((1, W), jnp.uint32)], axis=0)
    downright = jnp.concatenate(
        [right[1:, :], jnp.zeros((1, W), jnp.uint32)], axis=0
    )
    return x | (right << 8) | (down << 16) | (downright << 24)


def bilinear_gather_pair(
    a: jnp.ndarray, b: jnp.ndarray, grid: ResampleGrid, bias_b=None
) -> tuple:
    """Resample TWO single-channel images through the same grid with half
    the gathers: each uint32 word packs the horizontal byte pair of both
    channels (a[y,x], a[y,x+1], b[y,x], b[y,x+1]); the window's lower row
    is the packed word at index base + W (the packing window never touches
    the last row, so base + W is always in range).

    Exactly the taps and weights of two bilinear_gather calls.

    bias_b: optional f32 map (dst shape) added to channel b's accumulator
    before rounding (float-weight grids only).  Used by the 'turbo'
    pipeline to restore the out-of-image fill value of a non-zero-coded
    channel: out-of-bounds taps carry weight 0, so a channel whose
    "black" encodes as 128 (LAB-B) needs +128*(1 - sum(w)) where the
    grid samples outside the source.
    """
    H, W = a.shape
    aw = a.astype(jnp.uint32)
    bw = b.astype(jnp.uint32)
    a_r = jnp.concatenate([aw[:, 1:], jnp.zeros((H, 1), jnp.uint32)], axis=1)
    b_r = jnp.concatenate([bw[:, 1:], jnp.zeros((H, 1), jnp.uint32)], axis=1)
    packed = (aw | (a_r << 8) | (bw << 16) | (b_r << 24)).reshape(-1)

    top = jnp.take(packed, grid.base, axis=0)
    bot = jnp.take(packed, grid.base + W, axis=0)

    def unpack(word, shift):
        return (word >> shift) & 0xFF

    out_a = combine_taps(unpack(top, 0), unpack(top, 8), unpack(bot, 0),
                         unpack(bot, 8), grid)
    out_b = combine_taps(unpack(top, 16), unpack(top, 24), unpack(bot, 16),
                         unpack(bot, 24), grid, bias=bias_b)
    return out_a, out_b


def bilinear_gather(img: jnp.ndarray, grid: ResampleGrid) -> jnp.ndarray:
    """Resample ``img`` through a precomputed grid.

    Args:
        img: (H, W) or (H, W, C) uint8 source image matching grid.src_size.
        grid: precomputed ResampleGrid.

    Returns:
        uint8 image of shape grid.dst_shape (+ channel dim if present).
    """
    if img.ndim == 3:
        out = [bilinear_gather(img[..., c], grid) for c in range(img.shape[2])]
        return jnp.stack(out, axis=-1)

    packed = _pack_2x2(img).reshape(-1)
    taps = jnp.take(packed, grid.base, axis=0)
    p00 = taps & 0xFF
    p01 = (taps >> 8) & 0xFF
    p10 = (taps >> 16) & 0xFF
    p11 = (taps >> 24) & 0xFF
    return combine_taps(p00, p01, p10, p11, grid)
