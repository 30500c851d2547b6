"""The device policy of the port's command-line entry points: the device a
``--device`` name means (no fall-back to the CPU), and the line that names
it in a record."""

from __future__ import annotations

import subprocess

import torch


def device_of(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA name without CUDA fails."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def device_line(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
