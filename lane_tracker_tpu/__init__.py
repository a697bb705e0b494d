"""lane_tracker_tpu: a lane detection and tracking framework in JAX.

A ground-up JAX/XLA re-design of the classical lane tracking pipeline
found in pierluigiferrari/lane_tracker (see /root/reference): per-frame camera
undistortion, bird's-eye perspective warp, adaptive color thresholding and
morphology, lane-pixel search (sliding-window / band), second-degree
polynomial fitting, validity checking, temporal smoothing, and overlay
rendering -- all as pure, fixed-shape, jit-compilable functions that batch
with `vmap`, sequence with `lax.scan`, and shard across devices with
`jax.sharding`.

Top-level API:
    LaneTracker          -- stateful wrapper matching the reference API
                            (reference: lane_tracker.py:85-1209)
    TrackerConfig        -- frozen config pytree covering every reference knob
    load_camera_calib    -- import reference cam_calib.p  (utils.py:13-26)
    load_warp_params     -- import reference warp_params.p (utils.py:28-55)
"""

from lane_tracker_tpu.calib.io import (
    load_camera_calib,
    load_warp_params,
    load_calibration_npz,
    save_calibration_npz,
)
from lane_tracker_tpu.tracker.config import TrackerConfig, PRESETS
from lane_tracker_tpu.tracker.tracker import LaneTracker

__version__ = "0.1.0"

__all__ = [
    "LaneTracker",
    "TrackerConfig",
    "PRESETS",
    "load_camera_calib",
    "load_warp_params",
    "load_calibration_npz",
    "save_calibration_npz",
    "__version__",
]
