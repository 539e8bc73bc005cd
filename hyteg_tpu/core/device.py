"""What the benchmarks and the smoke run report about the device."""

from __future__ import annotations

import subprocess

import jax


def card_info() -> list[str]:
    """Name and power limit of each GPU, one line per card, as nvidia-smi
    prints them.  Read in a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_stamp() -> dict:
    """Platform, kind and count of the devices JAX uses, and the cards'
    names and power limits: every benchmark line carries these."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "cards": card_info()}
