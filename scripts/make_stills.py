"""Decode the four benchmark stills into assets/stills.npz.

The throughput path's stills cycle (frame911, frame971, test4,
straight_lines1) is stored pre-decoded so that loading it needs only
numpy.  The decode is PIL's, exactly as the bench oracles
(assets/bench_oracle*.npz) were computed on: another JPEG decoder can
move pixel values and with them the validity trace.

Usage: python scripts/make_stills.py
Writes assets/stills.npz with ``names`` (4,) and ``frames``
(4, 720, 1280, 3) uint8.
"""

import pathlib

import numpy as np
from PIL import Image

STILLS = ("frame911.jpg", "frame971.jpg", "test4.jpg", "straight_lines1.jpg")
ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"


def decode_stills() -> np.ndarray:
    return np.stack([np.asarray(Image.open(ASSETS / n).convert("RGB"))
                     for n in STILLS])


def main():
    frames = decode_stills()
    assert frames.shape == (4, 720, 1280, 3) and frames.dtype == np.uint8
    np.savez_compressed(ASSETS / "stills.npz", names=np.array(STILLS),
                        frames=frames)


if __name__ == "__main__":
    main()
