"""The card's accelerator plugin: detection, naming and visibility (the
counterpart of ``ray_tpu/accelerators/tpu.py``, whose
``TPUAcceleratorManager`` it takes the place of, with ``resource_name``
``"GPU"``).

Detection does not initialise CUDA in the driver (JAX's manager avoids
importing jax there for the same reason: the driver must not take a
context on a card its workers are to hold).  The cards are counted from
``CUDA_VISIBLE_DEVICES`` when it is set, then from the driver's entries
under ``/proc/driver/nvidia/gpus``, then from ``nvidia-smi -L``.

A worker is pinned to its granted cards by ``CUDA_VISIBLE_DEVICES``, over
the parent's own visible list: with ``CUDA_VISIBLE_DEVICES=2,3`` in the
driver, grant ``[1]`` is card ``3``.  The host is one node, so there is no
slice to reserve (``slice_resources`` is empty) and multi-slice
coordination (``get_tpu_coordinator_env_vars``) raises.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
from typing import Dict, List, Optional

from .accelerator import AcceleratorManager, register_accelerator

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
MULTI_SLICE = 'not ported: ROADMAP Queue 1 item 3(c), "multi-slice"'


def _smi(*args: str) -> List[str]:
    """Lines of ``nvidia-smi args`` ([] where it is missing or fails)."""
    try:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    if out.returncode != 0:
        return []
    return [line.strip() for line in out.stdout.splitlines()
            if line.strip()]


def _visible() -> Optional[List[str]]:
    """The parent's ``CUDA_VISIBLE_DEVICES`` entries (None when unset)."""
    raw = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if raw is None:
        return None
    return [c.strip() for c in raw.split(",") if c.strip() != ""]


class CUDAAcceleratorManager(AcceleratorManager):
    resource_name = "GPU"
    #: Where the NVIDIA driver lists its cards, one directory each.
    PROC_GPUS = "/proc/driver/nvidia/gpus"

    @staticmethod
    def visibility_env(chip_ids: List[int]) -> Dict[str, str]:
        visible = _visible()
        if visible is not None and any(c >= len(visible) for c in chip_ids):
            raise RuntimeError(
                f"cards {chip_ids} were granted, but this process sees "
                f"{CUDA_VISIBLE_DEVICES_ENV}={','.join(visible)!r}")
        ids = [visible[c] if visible is not None else str(c)
               for c in chip_ids]
        return {CUDA_VISIBLE_DEVICES_ENV: ",".join(ids)}

    @staticmethod
    def detect_num_chips() -> int:
        """Cards on this host, without initialising CUDA."""
        visible = _visible()
        if visible is not None:
            return len(visible)
        cards = glob.glob(os.path.join(CUDAAcceleratorManager.PROC_GPUS,
                                       "*"))
        if cards:
            return len(cards)
        return sum(1 for line in _smi("-L") if line.startswith("GPU "))

    @staticmethod
    def card_name() -> Optional[str]:
        """The first card's name, e.g. "NVIDIA H100 80GB HBM3"."""
        for info in sorted(glob.glob(os.path.join(
                CUDAAcceleratorManager.PROC_GPUS, "*", "information"))):
            try:
                with open(info) as f:
                    for line in f:
                        if line.startswith("Model:"):
                            return line.split(":", 1)[1].strip()
            except OSError:
                continue
        names = _smi("--query-gpu=name", "--format=csv,noheader")
        return names[0] if names else None

    @staticmethod
    def type_from_name(name: Optional[str]) -> Optional[str]:
        """'NVIDIA H100 80GB HBM3' -> 'H100', 'Tesla V100-SXM2-16GB' ->
        'V100' (None when no model token is found)."""
        for token in re.split(r"[\s\-_]+", name or ""):
            if re.fullmatch(r"[A-Z]{1,3}\d{2,4}[A-Za-z]?", token):
                return token
        return None

    @staticmethod
    def accelerator_type() -> Optional[str]:
        return CUDAAcceleratorManager.type_from_name(
            CUDAAcceleratorManager.card_name())

    @staticmethod
    def set_visible_chips(chip_ids: List[int]) -> None:
        os.environ.update(CUDAAcceleratorManager.visibility_env(chip_ids))

    @staticmethod
    def get_current_process_visible_chips() -> Optional[List[int]]:
        visible = _visible()
        return None if visible is None else [int(c) for c in visible]


def get_tpu_coordinator_env_vars(slice_id: int, num_slices: int,
                                 coordinator_address: str) -> Dict[str, str]:
    """JAX's multi-slice (DCN) coordination env: one host has no slices."""
    raise NotImplementedError(f"multi-slice coordination is {MULTI_SLICE}")


register_accelerator(CUDAAcceleratorManager)
