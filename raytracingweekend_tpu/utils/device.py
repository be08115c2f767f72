"""What a measurement ran on: the JAX device and the card's power limit.

Every timing this repository prints names its device, because a number
taken on one card (or its power limit) says nothing about another.
"""
from __future__ import annotations

import subprocess

import jax


def nvidia_smi_line() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them, or why
    they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc {out.returncode})"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def describe() -> dict:
    """{platform, kind, count} of the default backend, as JAX reports it."""
    dev = jax.devices()
    return {"platform": dev[0].platform, "kind": dev[0].device_kind,
            "count": len(dev)}

