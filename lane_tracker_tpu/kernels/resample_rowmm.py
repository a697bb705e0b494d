"""Tile-structured resampling as slice gathers + one-hot matmul contractions.

The per-pixel packed gather in resample.py is shaped for big batches,
but a SINGLE frame's gather prices each of its ~1.2M scalar indices
individually.

This module exploits the structure the per-pixel gather ignores: real
rectification/undistortion maps are SMOOTH, so the source pixels feeding
any small destination tile live in a small contiguous source rectangle
(for the shipped calibration: the bird's-eye homography is exactly
row-preserving — h21 = h31 = 0 to 1e-16 — so a destination row's slab is
2 source rows; undistortion wobbles by <= 3 source rows per 32-column
tile).  Resampling then decomposes into, per (row, tile):

  1. ONE contiguous source slab read of static shape (R+1, omega) — a
     vmapped dynamic_slice, i.e. a gather of ~40k contiguous slabs
     instead of ~1.2M scalars;
  2. an exact in-slab tap selection taps[i] = slab[r[i], k[i]], phrased
     as a one-hot matmul so the matrix units do the data movement.  One-hot
     bf16 x values <= 255 (exact in bf16) accumulated in f32 with
     exactly one nonzero term per output is EXACT — the four taps equal
     the per-pixel gather's taps bit for bit, and the shared
     resample.combine_taps applies the grid's own weights, so outputs
     are bit-identical to bilinear_gather / bilinear_gather_pair by
     construction (asserted in tests/test_resample.py).

The one-hot tensor costs (Hd, nT, R*(omega-1), tile) bf16 — hundreds of
MB for the full warp at tile=32 — streamed once per frame in place of
the scalar gather.  Whether that wins on this device at small T is not
yet measured.

Reference semantics carried: cv2.warpPerspective/undistort call sites
lane_tracker.py:832-834 (via the grids built in calib/).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from lane_tracker_tpu.kernels.resample import ResampleGrid, combine_taps


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RowMMGrid:
    """Host-precomputed tile structure for one ResampleGrid.

    iy0:    (Hd, nT) i32 — first source row of each tile's slab.
    starts: (Hd, nT) i32 — first source column of each tile's slab.
    onehot: (Hd, nT, R*(omega-1), tile) bf16 — tap-selection matrices;
            column i holds a single 1 at flat index r*(omega-1)+k where
            (r, k) locate destination pixel i's top-left tap inside the
            slab.
    """

    iy0: jnp.ndarray
    starts: jnp.ndarray
    onehot: jnp.ndarray
    src_size: tuple  # (Ws, Hs) static
    dst_size: tuple  # (Wd, Hd) static
    meta: tuple  # (R, omega, tile, nT, Wp) static

    def tree_flatten(self):
        return (self.iy0, self.starts, self.onehot), (
            self.src_size, self.dst_size, self.meta)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def build_rowmm(grid: ResampleGrid, tile: int = 32, max_rows: int = 8,
                max_window: int = 160) -> RowMMGrid | None:
    """Derive the tile structure of ``grid``; None if it has none (a
    tile's source rows span > max_rows or columns span > max_window —
    then the per-pixel gather stays)."""
    base = np.asarray(grid.base)
    Ws, Hs = grid.src_size
    Hd, Wd = base.shape
    by = (base // Ws).astype(np.int64)
    bx = (base - by * Ws).astype(np.int64)

    nT = -(-Wd // tile)
    pad_x = nT * tile - Wd
    if pad_x:
        # Padded destination columns replicate the edge selection; they
        # are sliced off after contraction.
        bx = np.pad(bx, ((0, 0), (0, pad_x)), mode="edge")
        by = np.pad(by, ((0, 0), (0, pad_x)), mode="edge")
    bxt = bx.reshape(Hd, nT, tile)
    byt = by.reshape(Hd, nT, tile)

    R = int((byt.max(axis=2) - byt.min(axis=2)).max()) + 1
    if R > max_rows:
        return None
    # Slabs read rows iy0 .. iy0+R (R+1 rows; the +1 feeds the lower
    # bilinear taps).  base is clipped to by <= Hs-2, so slabs fit after
    # clamping iy0, and row offsets stay within [0, R-1].
    iy0 = np.minimum(byt.min(axis=2), Hs - 1 - R)
    r_off = byt - iy0[:, :, None]
    assert r_off.min() >= 0 and r_off.max() <= R - 1

    Wp = Ws + 2  # bx+1 <= Ws-1 is real data; the pad is never selected
    span = int((bxt.max(axis=2) - bxt.min(axis=2)).max()) + 2
    omega = span
    for _ in range(4):  # starts depend on omega via the right-edge clamp
        starts = np.clip(bxt.min(axis=2), 0, Wp - omega)
        need = int((bxt.max(axis=2) - starts).max()) + 2
        if need <= omega:
            break
        omega = need
    else:
        return None
    if omega > max_window:
        return None
    offs = bxt - starts[:, :, None]
    assert offs.min() >= 0 and offs.max() <= omega - 2

    om1 = omega - 1
    K = R * om1
    onehot = np.zeros((Hd, nT, K, tile), np.float32)
    yy, tt, ii = np.meshgrid(np.arange(Hd), np.arange(nT), np.arange(tile),
                             indexing="ij")
    onehot[yy, tt, r_off * om1 + offs, ii] = 1.0
    return RowMMGrid(
        iy0=jnp.asarray(iy0, jnp.int32),
        starts=jnp.asarray(starts, jnp.int32),
        onehot=jnp.asarray(onehot, jnp.bfloat16),
        src_size=(int(Ws), int(Hs)),
        dst_size=(int(Wd), int(Hd)),
        meta=(int(R), int(omega), int(tile), int(nT), int(Wp)),
    )


def _taps_rowmm(planes: jnp.ndarray, mm: RowMMGrid):
    """The four bilinear taps of every plane: 4 x (P, Hd, Wd) f32 exact.

    planes: (P, Hs, Ws) uint8 source images sharing the grid.
    Order: p00, p01, p10, p11 (window-slot convention of ResampleGrid).
    """
    P = planes.shape[0]
    R, omega, tile, nT, Wp = mm.meta
    Wd, Hd = mm.dst_size
    x = jnp.pad(planes, ((0, 0), (0, 1), (0, Wp - planes.shape[2])))

    def slab(iy, s):
        return jax.lax.dynamic_slice(x, (0, iy, s), (P, R + 1, omega))

    win = jax.vmap(jax.vmap(slab))(mm.iy0, mm.starts)
    # win: (Hd, nT, P, R+1, omega)
    om1 = omega - 1

    # bf16 x bf16 -> f32 on the GPU's tensor cores; the CPU backend's
    # batched DotThunk lacks that combination, so contract in f32 there
    # (equally exact: both dtypes hold 0..255 and the one-hot exactly,
    # and each output accumulates exactly one nonzero term).
    cdt = jnp.float32 if jax.default_backend() == "cpu" else jnp.bfloat16
    oh = mm.onehot.astype(cdt)

    def contract(r0, k0):
        w = win[:, :, :, r0:r0 + R, k0:k0 + om1]
        w = w.reshape(Hd, nT, P, R * om1).astype(cdt)
        t = jnp.einsum("ytpk,ytki->pyti", w, oh,
                       preferred_element_type=jnp.float32)
        return t.reshape(P, Hd, nT * tile)[:, :, :Wd]

    return (contract(0, 0), contract(0, 1), contract(1, 0), contract(1, 1))


def gather_planes_rowmm(planes, grid: ResampleGrid, mm: RowMMGrid,
                        biases=None):
    """Resample a stack of planes through one grid in a single slab pass:
    plane p's output is bit-identical to bilinear_gather(planes[p], grid)
    (with optional per-plane bias, float grids only)."""
    p00, p01, p10, p11 = _taps_rowmm(planes, mm)
    outs = []
    for p in range(planes.shape[0]):
        bias = None if biases is None else biases[p]
        outs.append(combine_taps(p00[p], p01[p], p10[p], p11[p], grid,
                                 bias=bias))
    return jnp.stack(outs)


def bilinear_gather_pair_rowmm(a, b, grid: ResampleGrid, mm: RowMMGrid,
                               bias_b=None):
    """Bit-identical to resample.bilinear_gather_pair(a, b, grid) — same
    taps (one-hot-exact), same combine_taps weights/rounding."""
    p00, p01, p10, p11 = _taps_rowmm(jnp.stack([a, b]), mm)
    out_a = combine_taps(p00[0], p01[0], p10[0], p11[0], grid)
    out_b = combine_taps(p00[1], p01[1], p10[1], p11[1], grid, bias=bias_b)
    return out_a, out_b


def bilinear_gather_rowmm(img, grid: ResampleGrid, mm: RowMMGrid):
    """Bit-identical to resample.bilinear_gather(img, grid)."""
    if img.ndim == 3:
        planes = jnp.moveaxis(img, -1, 0)
    else:
        planes = img[None]
    p00, p01, p10, p11 = _taps_rowmm(planes, mm)
    out = combine_taps(p00, p01, p10, p11, grid)
    return jnp.moveaxis(out, 0, -1) if img.ndim == 3 else out[0]
