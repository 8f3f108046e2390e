"""The accelerator a measurement runs on, for the entry points that report
device numbers (chip_smoke.py, bench.py, scripts/stage_times.py).

A measurement that finds no GPU stops (exit code 2) instead of timing the
CPU; `rehearse=True` is the explicit CPU rehearsal at tiny sizes.
"""

from __future__ import annotations

import subprocess
import sys


def nvidia_smi() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them, or ''
    when nvidia-smi is missing or fails."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.strip() if r.returncode == 0 else ""


def require_gpu(rehearse: bool = False):
    """(jax devices, card label).  Exits with code 2 when JAX's default
    device is not a GPU, unless rehearsing; on a GPU nvidia-smi must answer.
    The label is nvidia-smi's line for the first card (name and power
    limit), else `platform:device_kind`."""
    import jax
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu" and not rehearse:
        print(f"no GPU: jax reports platform {d0.platform!r} "
              f"(--rehearse runs the CPU rehearsal)", file=sys.stderr)
        sys.exit(2)
    smi = nvidia_smi()
    if d0.platform == "gpu" and not smi:
        print("nvidia-smi did not report the card", file=sys.stderr)
        sys.exit(2)
    card = smi.splitlines()[0] if smi else f"{d0.platform}:{d0.device_kind}"
    return devs, card


def describe(devs) -> dict:
    """The device as JAX reports it (platform, device_kind, count)."""
    d0 = devs[0]
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}
