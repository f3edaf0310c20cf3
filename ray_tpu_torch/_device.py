"""Device resolution for the port's entry points, and the card's identity for
reports.

Every entry point takes a ``device``.  ``None`` means the card: the port runs
on CUDA unless the caller asks for the CPU (as the CPU tests do).  A missing
card is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if CUDA is asked for and no card is
    visible, or for any device type other than ``cuda`` and ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; ray_tpu_torch runs on the card "
            "unless the caller passes device='cpu'")
    return dev


def on_stream(stream: Optional["torch.cuda.Stream"]):
    """``torch.cuda.stream(stream)``: the device work enqueued inside runs on
    ``stream``; no context for ``None`` (the CPU has no streams)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def make_generator(device: DeviceLike = None, seed: int = 0
                   ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def card_power_line(index: int = 0) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    card ``index`` (e.g. ``"NVIDIA H100 80GB HBM3, 700.00 W"``), or None
    where nvidia-smi is missing.  Every number the port reports carries this
    line: a card set below its power limit runs slower under load."""
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        return None
    return res.stdout.strip()
