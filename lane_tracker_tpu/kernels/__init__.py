from lane_tracker_tpu.kernels.resample import (
    ResampleGrid,
    bilinear_gather,
    bilinear_gather_pair,
)

__all__ = [
    "ResampleGrid",
    "bilinear_gather",
    "bilinear_gather_pair",
]
