"""On-device lane overlay rendering.

JAX equivalent of ``LaneTracker.draw_lane`` (lane_tracker.py:629-662):
the reference fillPolys the region between the two smoothed lane graphs on a
bird's-eye canvas, unwarps it with Minv, and alpha-blends onto the frame.
Here the polygon between two single-valued graphs is rasterized directly as
a per-row interval mask (closed form, no polygon scan conversion), unwarped
through the shared gather kernel, and blended with saturating uint8 math
matching ``cv2.addWeighted(img, 1, lane, 0.3, 0)``.

Text annotation stays on the host (render/text.py) — it never feeds back
into tracking and would only serialize the hot path.
"""

from __future__ import annotations

import jax.numpy as jnp

from lane_tracker_tpu.kernels.resample import ResampleGrid, bilinear_gather


def lane_region_mask(
    warped_size,
    fitx_left,
    fitx_right,
    n_left,
    n_right,
    first_left,
    first_right,
) -> jnp.ndarray:
    """(H, W) uint8 mask (0/255) of the lane region between the two graphs.

    Inputs are poly_points_meta-style re-anchored graphs: row y of the lane
    region (y >= H - n) takes boundary x = fitx[first + y - (H - n)].
    Rows where either side lacks samples are left empty (the reference's
    closing polygon edge covers those rows only in rare partial-visibility
    frames; tracking is unaffected either way).
    """
    W, H = int(warped_size[0]), int(warped_size[1])
    ys = jnp.arange(H)

    def boundary(fitx, n, first):
        idx = first + ys - (H - n)
        has = ys >= (H - n)
        m = fitx.shape[0]
        return jnp.take(fitx, jnp.clip(idx, 0, m - 1)), has

    lx, lhas = boundary(fitx_left, n_left, first_left)
    rx, rhas = boundary(fitx_right, n_right, first_right)
    # The reference casts graph points to int before fillPoly
    # (lane_tracker.py:528, 647).
    lxi = jnp.trunc(lx)
    rxi = jnp.trunc(rx)
    xs = jnp.arange(W, dtype=jnp.float32)[None, :]
    row_ok = (lhas & rhas)[:, None]
    inside = row_ok & (xs >= lxi[:, None]) & (xs <= rxi[:, None])
    return jnp.where(inside, jnp.uint8(255), jnp.uint8(0))


def forward_bv_grid(M, img_size, warped_size):
    """Host precompute: each camera pixel's bird's-eye coordinates.

    cv2.warpPerspective(lane, Minv) samples the BV lane image at
    Minv^-1 @ p = (M/scale) @ p for each camera pixel p — i.e. the forward
    bird's-eye projection. Returns float32 (Hc, Wc) u and v arrays.
    """
    import numpy as np

    Wc, Hc = int(img_size[0]), int(img_size[1])
    Mf = np.asarray(M, dtype=np.float64)
    xs = np.arange(Wc, dtype=np.float64)
    ys = np.arange(Hc, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys)
    w = Mf[2, 0] * X + Mf[2, 1] * Y + Mf[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_w = np.where(np.abs(w) > 1e-12, 1.0 / w, 0.0)
    u = (Mf[0, 0] * X + Mf[0, 1] * Y + Mf[0, 2]) * inv_w
    v = (Mf[1, 0] * X + Mf[1, 1] * Y + Mf[1, 2]) * inv_w
    return u.astype(np.float32), v.astype(np.float32)


def lane_overlay_direct(
    frame: jnp.ndarray,
    left_coeffs: jnp.ndarray,
    right_coeffs: jnp.ndarray,
    n_left,
    n_right,
    first_left,
    first_right,
    u_grid: jnp.ndarray,
    v_grid: jnp.ndarray,
    warped_size,
    ploty_start: float,
    ploty_step: float,
    enable,
) -> jnp.ndarray:
    """Blend the lane region evaluated directly in camera space.

    Instead of rasterizing a bird's-eye mask and unwarping it (a
    per-pixel gather every frame), each camera pixel tests its precomputed BV
    coordinates against the smoothed boundary polynomials — closed-form
    elementwise math, zero gathers.  The re-anchored graph lookup
    fitx[first + v-(H-n)] becomes polyval at the affine ploty position.
    Edges get a 1-BV-pixel linear ramp approximating the bilinear
    softening of the unwarped mask.
    """
    W, H = int(warped_size[0]), int(warped_size[1])
    v = v_grid

    def boundary(coeffs, n, first):
        idx = first.astype(jnp.float32) + v - (H - n.astype(jnp.float32))
        y = jnp.float32(ploty_start) + jnp.float32(ploty_step) * idx
        c = coeffs.astype(jnp.float32)
        x = jnp.trunc(c[0] * y * y + c[1] * y + c[2])
        has = v >= (H - n.astype(jnp.float32))
        return x, has

    xl, lhas = boundary(left_coeffs, n_left, first_left)
    xr, rhas = boundary(right_coeffs, n_right, first_right)
    row_ok = lhas & rhas & (v <= H - 1) & (v >= 0)
    # Coverage ramps over one BV pixel on each side (soft edge).
    cov = jnp.clip(
        jnp.minimum(u_grid - xl + 1.0, xr - u_grid + 1.0), 0.0, 1.0
    ) * row_ok.astype(jnp.float32)
    add = jnp.rint(cov * jnp.float32(0.3 * 255.0)).astype(jnp.int32)
    add = jnp.where(enable, add, 0)
    g = jnp.minimum(frame[..., 1].astype(jnp.int32) + add, 255).astype(jnp.uint8)
    return jnp.stack([frame[..., 0], g, frame[..., 2]], axis=-1)


def lane_overlay(
    frame: jnp.ndarray,
    lane_mask: jnp.ndarray,
    unwarp_grid: ResampleGrid,
    enable,
) -> jnp.ndarray:
    """Blend the unwarped green lane region onto the camera frame.

    frame: (Hc, Wc, 3) uint8.  lane_mask: (H, W) uint8 bird's-eye mask.
    enable: () bool — when False the frame passes through unchanged (the
    reference's failure path without a previous lane, lane_tracker.py:1167).
    """
    green = bilinear_gather(lane_mask, unwarp_grid)  # (Hc, Wc) uint8
    # addWeighted(img, 1, lane, 0.3, 0): only the G channel of the lane
    # image is nonzero.
    add = jnp.rint(green.astype(jnp.float32) * jnp.float32(0.3)).astype(jnp.int32)
    add = jnp.where(enable, add, 0)
    g = jnp.minimum(frame[..., 1].astype(jnp.int32) + add, 255).astype(jnp.uint8)
    return jnp.stack([frame[..., 0], g, frame[..., 2]], axis=-1)
