"""Color space conversions, bit-exact with OpenCV's uint8 paths.

The reference extracts the LAB B-channel with ``cv2.cvtColor(img,
cv2.COLOR_RGB2LAB)`` (lane_tracker.py:208) and thresholds it with small
margins (C_b=5), so the conversion must match OpenCV to the unit.  OpenCV's
8-bit Lab path is fixed-point: an sRGB linearization LUT scaled by 255*8, a
cube-root LUT scaled by 2^15, and 2^12-scaled XYZ coefficients with the D65
white point folded in.  The tables are generated here at import time with
float32 arithmetic (matching OpenCV's softfloat table initialization — this
was validated bit-exact against cv2 over an exhaustive color grid), and the
per-pixel math is pure int32.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

_LAB_SHIFT = 12
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT  # 15
_GAMMA_TAB_SIZE = 256
_CBRT_TAB_SIZE = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)  # 3072

_D65 = (0.950456, 1.0, 1.088754)
_XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)


def _round_half_even(x):
    return np.rint(x).astype(np.int64)


@functools.lru_cache(maxsize=1)
def _tables():
    # sRGB linearization LUT, computed in float32 like OpenCV's softfloat init.
    i = np.arange(_GAMMA_TAB_SIZE, dtype=np.float32)
    x = (i / np.float32(255.0)).astype(np.float32)
    lo = (x / np.float32(12.92)).astype(np.float32)
    hi = (((x + np.float32(0.055)) / np.float32(1.055)) ** np.float32(2.4)).astype(
        np.float32
    )
    gamma = np.where(x <= np.float32(0.04045), lo, hi)
    gamma_tab = _round_half_even(
        (np.float32(255.0 * (1 << _GAMMA_SHIFT)) * gamma).astype(np.float32)
    ).astype(np.int32)

    # Cube-root LUT with the CIE linear segment below 0.008856.
    t = (
        np.arange(_CBRT_TAB_SIZE, dtype=np.float32)
        * (np.float32(1.0) / np.float32(255.0 * (1 << _GAMMA_SHIFT)))
    ).astype(np.float32)
    cbrt = np.where(
        t < np.float32(0.008856),
        t * np.float32(7.787) + np.float32(0.13793103448275862),
        np.cbrt(t, dtype=np.float32),
    )
    cbrt_tab = _round_half_even(
        (np.float32(1 << _LAB_SHIFT2) * cbrt).astype(np.float32)
    ).astype(np.int32)

    coeffs = np.zeros((3, 3), dtype=np.int32)
    for r in range(3):
        for c in range(3):
            coeffs[r, c] = _round_half_even(
                np.float64(
                    np.float32(_XYZ[r][c])
                    / np.float32(_D65[r])
                    * np.float32(1 << _LAB_SHIFT)
                )
            )
    return gamma_tab, cbrt_tab, coeffs


def _descale(v, n):
    return (v + (1 << (n - 1))) >> n


def rgb2lab_u8(img: jnp.ndarray) -> jnp.ndarray:
    """Convert an (H, W, 3) uint8 RGB image to OpenCV-exact uint8 LAB."""
    gamma_tab, cbrt_tab, C = _tables()
    gamma_tab = jnp.asarray(gamma_tab)
    cbrt_tab = jnp.asarray(cbrt_tab)

    rgb = img.astype(jnp.int32)
    R = jnp.take(gamma_tab, rgb[..., 0], axis=0)
    G = jnp.take(gamma_tab, rgb[..., 1], axis=0)
    B = jnp.take(gamma_tab, rgb[..., 2], axis=0)

    def f(row):
        acc = R * int(C[row, 0]) + G * int(C[row, 1]) + B * int(C[row, 2])
        idx = jnp.clip(_descale(acc, _LAB_SHIFT), 0, _CBRT_TAB_SIZE - 1)
        return jnp.take(cbrt_tab, idx, axis=0)

    fX, fY, fZ = f(0), f(1), f(2)
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = _descale(l_scale * fY + l_shift, _LAB_SHIFT2)
    a = _descale(500 * (fX - fY) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    b = _descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    lab = jnp.stack([L, a, b], axis=-1)
    return jnp.clip(lab, 0, 255).astype(jnp.uint8)


# LP-certified gamma polynomial: the unique-per-fit coefficients of a
# degree-12 Chebyshev-center LP solution (see _fit_gamma_poly) whose
# f32-Horner rint reproduces the integer gamma LUT EXACTLY on every
# power-branch input i in [11, 255], with margin 0.021 — an order of
# magnitude above worst-case f32 Horner noise at the table's 2040 output
# scale (~13 steps x 1 ulp(2048) ~ 0.003), so the rint is stable under
# ANY FMA-contraction choice a backend makes.  Baked as constants so the
# default 'fast' pipeline has no scipy dependency and no process-start
# refit (round-4 advisor, medium); _fit_gamma_poly keeps the LP for
# regeneration, and tests/test_color.py re-verifies rint-exactness of
# THESE constants both in numpy (both FMA orders) and exhaustively
# under jit.  u = (i - mid) / half, coefficients highest-first.
_GAMMA_POLY_MID = 133.0
_GAMMA_POLY_HALF = 122.0
_GAMMA_POLY_COEFS = (
    -44.081208940021156,
    -35.0394862240723,
    105.81190372931691,
    86.91622624219376,
    -88.51931702132121,
    -76.8666569982063,
    29.323830599210154,
    31.640361529067718,
    -11.53070519185922,
    56.55635092162949,
    553.7077317661957,
    953.1224678867455,
    478.4792508505659,
)


def _fit_gamma_poly():
    """Re-derive the LP-certified gamma polynomial (needs scipy).

    The sRGB gamma table has only 256 reachable inputs, so instead of
    approximating the curve (the declined "minimax gamma" trade), solve
    the Chebyshev-center LP  max m s.t. |P(i) - gamma_tab[i]| <= 0.5 - m
    over the power-branch inputs i in [11, 255]: degree 12 achieves
    m = 0.021.  Not called on any product path — the result is baked
    into _GAMMA_POLY_COEFS above; tests re-run this to pin the bake.

    (The cube-root table does NOT admit this: its entries sit as close
    as 0.002 to a rounding boundary — LP-certified — while f32 noise at
    the 2^15 scale is ~0.004/step, so no polynomial is rounding-stable
    there and the fast path keeps the transcendental cbrt with its
    corpus-proven tolerance contract.)

    Returns (coefs_highest_first, mid, half) for u = (i - mid) / half.
    """
    gamma_tab, _, _ = _tables()
    i = np.arange(256, dtype=np.float64)
    mask = i / 255.0 > 0.04045
    ii = i[mask]
    tab = gamma_tab[mask].astype(np.float64)
    deg = 12
    mid = (ii.min() + ii.max()) / 2
    half = (ii.max() - ii.min()) / 2
    u = (ii - mid) / half

    from scipy.optimize import linprog

    A = np.vander(u, deg + 1)
    n = len(u)
    Aub = np.block([[A, np.ones((n, 1))], [-A, np.ones((n, 1))]])
    bub = np.concatenate([0.5 + tab, 0.5 - tab])
    cobj = np.zeros(deg + 2)
    cobj[-1] = -1.0
    res = linprog(cobj, A_ub=Aub, b_ub=bub,
                  bounds=[(None, None)] * (deg + 2), method="highs")
    assert res.success and res.x[-1] > 0.015, res
    return tuple(float(c) for c in res.x[:-1]), float(mid), float(half)


def _verify_gamma_poly(coefs, mid, half):
    """Assert the polynomial's f32 rint reproduces the gamma table on all
    power-branch inputs under BOTH evaluation orders (plain mul-then-add
    and fused multiply-add)."""
    gamma_tab, _, _ = _tables()
    i = np.arange(256, dtype=np.float64)
    mask = i / 255.0 > 0.04045
    tab = gamma_tab[mask].astype(np.float64)
    u = (i[mask] - mid) / half
    uf = u.astype(np.float32)
    plain = np.full_like(uf, np.float32(coefs[0]))
    fused = plain.astype(np.float64)
    for c in coefs[1:]:
        plain = (plain * uf + np.float32(c)).astype(np.float32)
        fused = np.float32(
            fused * uf.astype(np.float64) + np.float64(np.float32(c))
        ).astype(np.float64)
    assert (np.rint(plain) == tab).all(), "gamma poly: plain f32 mismatch"
    assert (np.rint(fused) == tab).all(), "gamma poly: fma f32 mismatch"


@functools.lru_cache(maxsize=1)
def _gamma_poly():
    """The baked LP-certified polynomial, cheap-verified once per process
    (numpy only — no scipy on the product path)."""
    _verify_gamma_poly(_GAMMA_POLY_COEFS, _GAMMA_POLY_MID, _GAMMA_POLY_HALF)
    return _GAMMA_POLY_COEFS, _GAMMA_POLY_MID, _GAMMA_POLY_HALF


def _gamma_poly_f32(img_f32_i):
    """rint(255*8*gamma(i/255)) == gamma_tab[i] for integer-valued i
    in [0, 255] (exhaustively pinned by tests/test_color.py)."""
    coefs, mid, half = _gamma_poly()
    u = (img_f32_i - jnp.float32(mid)) * jnp.float32(1.0 / half)
    acc = jnp.full(u.shape, jnp.float32(coefs[0]))
    for c in coefs[1:]:
        acc = acc * u + jnp.float32(c)
    lin = jnp.rint(img_f32_i * jnp.float32(8.0 / 12.92))
    return jnp.where(img_f32_i <= jnp.float32(255.0 * 0.04045), lin,
                     jnp.rint(acc))


def rgb2lab_b_fast(img: jnp.ndarray) -> jnp.ndarray:
    """LAB B-channel via pure f32 arithmetic (no table gathers).

    Evaluates the LUT path's fixed-point pipeline arithmetically instead
    of through per-element table gathers, with the integer descales
    done in exact f32 integer math (all intermediates < 2^24).  Round 4
    replaced the three pow(2.4) gamma evaluations with a polynomial
    whose f32-Horner rint reproduces the integer gamma LUT EXACTLY on
    all 256 inputs under any FMA contraction (_gamma_poly; pinned
    exhaustively by tests/test_color.py).  The cube root stays
    transcendental — _gamma_poly's docstring has the LP certificate of
    why no polynomial is rounding-stable for that table — so the only
    deviation from rgb2lab_b_u8 remains cbrt's rare boundary rounding:
    measured <=1 intensity unit on <0.1% of pixels, corpus-parity
    proven.  The tracker's 'fast' pipeline uses this; 'compat' keeps
    the bit-exact LUT path.
    """
    xi = img.astype(jnp.float32)
    g = _gamma_poly_f32(xi)
    R, G, B = g[..., 0], g[..., 1], g[..., 2]

    _, _, C = _tables()

    def f(row):
        acc = R * float(C[row, 0]) + G * float(C[row, 1]) + B * float(C[row, 2])
        idx = jnp.clip(
            jnp.floor((acc + float(1 << (_LAB_SHIFT - 1))) / float(1 << _LAB_SHIFT)),
            0.0,
            float(_CBRT_TAB_SIZE - 1),
        )
        t = idx * jnp.float32(1.0 / (255.0 * (1 << _GAMMA_SHIFT)))
        cbrt = jnp.where(
            t < jnp.float32(0.008856),
            t * jnp.float32(7.787) + jnp.float32(0.13793103448275862),
            jnp.cbrt(t),
        )
        return jnp.rint(jnp.float32(1 << _LAB_SHIFT2) * cbrt)

    fY, fZ = f(1), f(2)
    b = jnp.floor(
        (200.0 * (fY - fZ) + float(128 * (1 << _LAB_SHIFT2)) + float(1 << (_LAB_SHIFT2 - 1)))
        / float(1 << _LAB_SHIFT2)
    )
    return jnp.clip(b, 0, 255).astype(jnp.uint8)


def rgb2lab_b_u8(img: jnp.ndarray) -> jnp.ndarray:
    """Only the LAB B-channel (the one the filter stage consumes,
    lane_tracker.py:208) — skips the L and a channels entirely."""
    gamma_tab, cbrt_tab, C = _tables()
    gamma_tab = jnp.asarray(gamma_tab)
    cbrt_tab = jnp.asarray(cbrt_tab)

    rgb = img.astype(jnp.int32)
    R = jnp.take(gamma_tab, rgb[..., 0], axis=0)
    G = jnp.take(gamma_tab, rgb[..., 1], axis=0)
    B = jnp.take(gamma_tab, rgb[..., 2], axis=0)

    def f(row):
        acc = R * int(C[row, 0]) + G * int(C[row, 1]) + B * int(C[row, 2])
        idx = jnp.clip(_descale(acc, _LAB_SHIFT), 0, _CBRT_TAB_SIZE - 1)
        return jnp.take(cbrt_tab, idx, axis=0)

    fY, fZ = f(1), f(2)
    b = _descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return jnp.clip(b, 0, 255).astype(jnp.uint8)
