import os

# The suite runs on the CPU backend with 8 virtual devices, so sharding and
# mesh tests have several devices without a card.  LT_TESTS_ON_CARD=1
# leaves the platform to JAX instead: that is how chip_smoke.py runs the
# card-only tests (marker ``gpu``) on a GPU.  XLA_FLAGS must be set before
# the CPU backend initializes.
ON_CARD = os.environ.get("LT_TESTS_ON_CARD") == "1"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import jax

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache: the suite is compile-dominated on the
# CPU backend, and the traced programs are identical run to run, so repeat
# runs hit the disk cache and skip compilation.  Keyed by HLO hash — a code
# change that alters a traced program misses and recompiles, so this is
# correctness-neutral.  JAX_COMPILATION_CACHE_DIR, when set, decides the
# directory (JAX reads it itself); otherwise LT_JAX_CACHE_DIR, else the
# committed tests/.jax_cache ("off" disables).  After changing
# compile-heavy code, run the suite and commit the new entries alongside.
_CACHE_DIR = os.environ.get(
    "LT_JAX_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parent / ".jax_cache"),
)
if _CACHE_DIR != "off":
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np
import pytest

REFERENCE_DIR = pathlib.Path("/root/reference")
ASSETS_DIR = pathlib.Path(__file__).resolve().parent.parent / "assets"


def _load_image(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def calib():
    """(CameraParams, WarpParams) from the repo's native npz artifact."""
    from lane_tracker_tpu.calib.io import load_calibration_npz

    return load_calibration_npz(ASSETS_DIR / "calibration.npz")


@pytest.fixture(scope="session")
def test_frame():
    """A real 1280x720 dashcam frame (RGB uint8)."""
    return _load_image(ASSETS_DIR / "test4.jpg")


@pytest.fixture(scope="session")
def frame_pair():
    """The consecutive-frame pair used for warm-start integration tests."""
    return (
        _load_image(ASSETS_DIR / "frame911.jpg"),
        _load_image(ASSETS_DIR / "frame971.jpg"),
    )


@pytest.fixture()
def card():
    """The GPU a ``gpu``-marked test runs on.  Skips on other backends —
    unless LT_TESTS_ON_CARD=1 says a card was expected, which fails."""
    if jax.default_backend() != "gpu":
        msg = f"needs a GPU; JAX backend is {jax.default_backend()!r}"
        if ON_CARD:
            pytest.fail(msg)
        pytest.skip(msg)
    return jax.devices()[0]


def has_cv2():
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        return False


requires_cv2 = pytest.mark.skipif(not has_cv2(), reason="cv2 not installed")
