"""Weighted quadratic least squares, poly sampling, validity, radius, ecc.

JAX replacements for the reference's estimation layer
(lane_tracker.py:502-627):

* :func:`fit_poly_mask` — ``np.polyfit(y, x, 2)`` over a pixel *mask*
  instead of gathered coordinate lists (lane_tracker.py:502-509).  The
  normal equations of weighted least squares with 0/1 weights are identical
  to the reference's list-based fit; shapes stay fixed.  Coordinates are
  standardized on the fly (data mean/std) so the 3x3 solve is perfectly
  conditioned in float32 — replacing np.polyfit's float64 + column scaling.

* :func:`poly_points_meta` — the sampling/filter/re-anchor behavior of
  ``get_poly_points`` (lane_tracker.py:511-528), expressed as fixed-shape
  metadata (in-bounds count, first index, sampled graph values).

* :func:`check_validity` — the two-stage plausibility test
  (lane_tracker.py:561-627) including the width-as-height y-eval quirk.

* :func:`curve_radius` / :func:`eccentricity` — lane_tracker.py:530-559.
  The reference refits in metric space; a linear reparametrization of both
  axes maps the pixel-space LSQ solution exactly, so the metric coefficients
  are obtained by closed-form transformation instead of a second fit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lane_tracker_tpu.tracker.config import ValidityConfig


def fit_poly_mask(mask: jnp.ndarray) -> jnp.ndarray:
    """Fit x = A y^2 + B y + C over the True pixels of ``mask`` (H, W).

    Returns (3,) float32 [A, B, C].  Undefined when the mask has < 3
    distinct rows — callers gate on detection flags.
    """
    H, W = mask.shape
    w = mask.astype(jnp.float32)
    xs = jnp.arange(W, dtype=jnp.float32)
    row_n = w.sum(axis=1)  # (H,)
    row_sx = w @ xs  # (H,)
    return fit_poly_rows(row_n, row_sx, W)


def fit_poly_rows(row_n: jnp.ndarray, row_sx: jnp.ndarray, W: int) -> jnp.ndarray:
    """Quadratic LSQ from per-row pixel counts and x-sums.

    The weighted normal equations only involve row-level moments (every
    pixel in a row shares its y), so (row_n, row_sx) fully determine the
    fit — this is what lets the chunk pipeline's sequential back half run
    on prefix-sum interval lookups (ops/integrals.py) instead of masks.

    Accepts (H,) inputs -> (3,) coefficients, or (..., H) batches ->
    (..., 3): the sequential back half stacks the left/right sides into
    one call so every reduction and the 3x3 solve run once per step.
    """
    H = row_n.shape[-1]
    row_n = row_n.astype(jnp.float32)
    row_sx = row_sx.astype(jnp.float32)
    ys = jnp.arange(H, dtype=jnp.float32)
    n = row_n.sum(-1)
    n_safe = jnp.maximum(n, 1.0)

    # Standardize y by data moments for conditioning.
    my = (row_n * ys).sum(-1) / n_safe
    vy = (row_n * (ys * ys)).sum(-1) / n_safe - my * my
    sy = jnp.sqrt(jnp.maximum(vy, 1e-12))
    t = (ys - my[..., None]) / sy[..., None]

    # Center x (scale by W for magnitude only).
    mx = row_sx.sum(-1) / n_safe
    u_row = (row_sx - row_n * mx[..., None]) / W  # sum of u over each row

    t2 = t * t
    S1 = (row_n * t).sum(-1)
    S2 = (row_n * t2).sum(-1)
    S3 = (row_n * (t2 * t)).sum(-1)
    S4 = (row_n * (t2 * t2)).sum(-1)
    P0 = u_row.sum(-1)
    P1 = (u_row * t).sum(-1)
    P2 = (u_row * t2).sum(-1)

    M = jnp.stack(
        [
            jnp.stack([S4, S3, S2], axis=-1),
            jnp.stack([S3, S2, S1], axis=-1),
            jnp.stack([S2, S1, n], axis=-1),
        ],
        axis=-2,
    )
    b = jnp.stack([P2, P1, P0], axis=-1)
    # Degenerate masks (fewer than 3 points) would make the solve singular;
    # substitute the identity so the result stays finite. Callers gate on
    # detection flags, matching the reference which never fits empty sets.
    degenerate = n < 3.0
    M = jnp.where(degenerate[..., None, None], jnp.eye(3, dtype=jnp.float32), M)
    b = jnp.where(degenerate[..., None], jnp.zeros((3,), jnp.float32), b)
    abc = jnp.linalg.solve(M, b[..., None])[..., 0]  # u = a t^2 + b t + c
    a, bb, c = abc[..., 0], abc[..., 1], abc[..., 2]

    # Back-transform: x = W*(a ((y-my)/sy)^2 + b (y-my)/sy + c) + mx
    A = W * a / (sy * sy)
    B = W * (bb / sy - 2.0 * a * my / (sy * sy))
    C = W * (a * my * my / (sy * sy) - bb * my / sy + c) + mx
    return jnp.stack([A, B, C], axis=-1)


class PolyPoints(NamedTuple):
    """Fixed-shape rendition of get_poly_points (lane_tracker.py:511-528).

    The reference samples x over a bottom-anchored ploty grid, drops
    out-of-image samples, and re-synthesizes y as a fresh bottom-anchored
    ramp of the surviving count.  Assuming the survivors form one contiguous
    run (true for any quadratic that exits the image at most once per end),
    the re-anchored graph is: row y in [H-n, H) maps to sample
    fitx[first + (y - (H-n))].
    """

    fitx: jnp.ndarray  # (n_samples,) float32 — x at each ploty sample
    inb: jnp.ndarray  # (n_samples,) bool — sample within [0, W-1]
    n: jnp.ndarray  # () int32 — number of surviving samples
    first: jnp.ndarray  # () int32 — index of the first survivor


def ploty_grid(warped_size, partial: float) -> jnp.ndarray:
    """The reference's ploty sampling grid under 2017-NumPy truncation:
    np.linspace(H*(1-partial), H-1, int(H*partial))."""
    W, H = int(warped_size[0]), int(warped_size[1])
    num = int(H * partial)
    return jnp.linspace(H * (1.0 - partial), H - 1.0, num).astype(jnp.float32)


def poly_points_meta(coeffs: jnp.ndarray, ploty: jnp.ndarray, warped_size) -> PolyPoints:
    """Accepts (3,) coefficients or an (..., 3) batch; field shapes follow
    (the back half stacks left/right so both sides sample in one call)."""
    W = int(warped_size[0])
    c = coeffs.astype(jnp.float32)
    fitx = (
        c[..., 0:1] * ploty * ploty + c[..., 1:2] * ploty + c[..., 2:3]
    )
    inb = (fitx <= W - 1) & (fitx >= 0)
    n = jnp.sum(inb.astype(jnp.int32), axis=-1)
    m = ploty.shape[0]
    idx = jnp.arange(m)
    first = jnp.min(jnp.where(inb, idx, m), axis=-1).astype(jnp.int32)
    return PolyPoints(fitx=fitx, inb=inb, n=n, first=first)


def check_validity(
    left_coeffs: jnp.ndarray,
    right_coeffs: jnp.ndarray,
    n_left: jnp.ndarray,
    n_right: jnp.ndarray,
    warped_size,
    vcfg: ValidityConfig,
) -> jnp.ndarray:
    """Two-stage plausibility test on a candidate coefficient pair.

    n_left/n_right are the surviving-sample counts from poly_points_meta
    (the reference's len(left_fit_y), lane_tracker.py:567, 572-573).
    Returns a () bool.
    """
    W, H = int(warped_size[0]), int(warped_size[1])
    base = W if vcfg.y_eval_from_width else H
    y1 = jnp.float32(base - 1)
    nmin = jnp.minimum(n_left, n_right).astype(jnp.float32)
    y2 = jnp.float32(base) - jnp.trunc(nmin * 0.35)
    y3 = jnp.float32(base) - jnp.trunc(nmin * 0.75)

    lc = left_coeffs.astype(jnp.float32)
    rc = right_coeffs.astype(jnp.float32)

    def at(c, y):
        return c[0] * y * y + c[1] * y + c[2]

    x1 = jnp.abs(at(lc, y1) - at(rc, y1))
    x2 = jnp.abs(at(lc, y2) - at(rc, y2))
    x3 = jnp.abs(at(lc, y3) - at(rc, y3))
    dist_ok = (
        (x1 >= vcfg.min_dist_y1)
        & (x1 <= vcfg.max_dist_y1)
        & (x2 >= vcfg.min_dist_y2)
        & (x2 <= vcfg.max_dist_y2)
        & (x3 >= vcfg.min_dist_y3)
        & (x3 <= vcfg.max_dist_y3)
    )

    def deriv(c, y):
        return 2.0 * c[0] * y + c[1]

    n1 = jnp.abs(deriv(lc, y1) - deriv(rc, y1))
    n2 = jnp.abs(deriv(lc, y3) - deriv(rc, y3))
    tangent_ok = (n1 < vcfg.tangent_thresh) & (n2 < vcfg.tangent_thresh)
    return dist_ok & tangent_ok


def metric_coeffs(coeffs: jnp.ndarray, mppv: float, mpph: float) -> jnp.ndarray:
    """Transform a pixel-space fit into the metric-space fit.

    If x = A y^2 + B y + C minimizes the weighted LSQ, then the fit of
    (x*mpph) on (y*mppv) over the same pixels is exactly
    [A*mpph/mppv^2, B*mpph/mppv, C*mpph] (linear reparametrization maps the
    normal equations one-to-one) — equivalent to the reference's second
    np.polyfit in metric space (lane_tracker.py:534-535).
    """
    A, B, C = coeffs[0], coeffs[1], coeffs[2]
    return jnp.stack(
        [A * mpph / (mppv * mppv), B * mpph / mppv, C * mpph]
    )


def curve_radius_m(coeffs: jnp.ndarray, warped_size, mppv: float, mpph: float):
    """Curve radius in meters at y_eval = warped height, int-truncated
    (lane_tracker.py:537-542)."""
    m = metric_coeffs(coeffs, mppv, mpph)
    y_eval = jnp.float32(int(warped_size[1]))
    slope = 2.0 * m[0] * y_eval * jnp.float32(mppv) + m[1]
    r = (1.0 + slope * slope) ** 1.5 / jnp.abs(2.0 * m[0])
    return jnp.trunc(r)


def eccentricity_m(left_bottom_x, right_bottom_x, warped_size, mpph: float):
    """Signed lane-center offset in meters (lane_tracker.py:551-559).

    left_bottom_x/right_bottom_x: the bottom-most smoothed graph x values
    (already int-truncated, as the reference's get_poly_points casts them).
    """
    mid = jnp.float32(int(warped_size[0]) // 2)
    dx1 = mid - left_bottom_x
    dx2 = right_bottom_x - mid
    return ((dx1 - dx2) / 2.0) * jnp.float32(mpph)
