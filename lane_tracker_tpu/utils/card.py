"""The GPU a measurement runs on, as commands that measure must name it.

Every device number this repo prints sits beside the card's name and power
limit (a card set below its maximum power runs slower under load), and a
measurement that finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit, one line per card.  Raises
    (FileNotFoundError, CalledProcessError) where there is no card."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """The JAX devices, if JAX runs on a GPU; SystemExit otherwise."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"needs a GPU; JAX's backend is {backend!r}")
    return jax.devices()


def device_summary() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
