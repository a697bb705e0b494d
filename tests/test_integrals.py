"""Packed row prefixes (ops/integrals.build_row_prefixes) against a plain
int64 cumulative-sum reference.

The prefixes are a bf16 x bf16 -> f32 matmul against a triangular ones
matrix; they are exact only while every partial sum stays an integer the
f32 accumulator holds, so all-ones rows at the widest widths are the
worst case.
"""

import numpy as np
import pytest

import jax

from lane_tracker_tpu.ops.integrals import (
    build_row_prefixes,
    row_prefixes_reference,
)

# 96: the tiny test geometry; 672: the corridor's compute width; 1080: the
# shipped warped width; 1280: the camera width.
WIDTHS = (96, 672, 1080, 1280)
PATTERNS = ("empty", "sparse", "dense", "ones")


def _binary(pattern, W, H=24, seed=0):
    rng = np.random.default_rng(seed)
    if pattern == "empty":
        return np.zeros((H, W), np.uint8)
    if pattern == "ones":
        return np.full((H, W), 255, np.uint8)
    p = {"sparse": 0.02, "dense": 0.7}[pattern]
    return np.where(rng.random((H, W)) < p, 255, 0).astype(np.uint8)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("W", WIDTHS)
def test_row_prefixes_equal_cumsum_reference(W, pattern):
    binary = _binary(pattern, W)
    got = np.asarray(jax.jit(build_row_prefixes)(binary).packed)
    want = row_prefixes_reference(binary)
    assert got.dtype == np.int32 and got.shape == (binary.shape[0], W + 1)
    np.testing.assert_array_equal(got.astype(np.int64), want)
