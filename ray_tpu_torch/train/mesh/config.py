"""MeshConfig: the declarative mesh shape a train worker group forms (a copy
of ray_tpu/train/mesh/config.py over the port's ``parallel.mesh``).

Carried on ``ScalingConfig.mesh_config`` and resolved against the ACTUAL
world size at every group (re)formation, so elastic resizes re-form the
mesh at a new shape instead of refusing ("a live mesh cannot be resized"
stays true — resize = teardown + re-form + resharding restore).

Axis semantics follow ``parallel.mesh.MeshSpec``: sizes are per named
axis (dp/fsdp/tp/sp/ep/pp), at most one axis may be ``-1`` ("absorb the
remaining devices"), and ``auto=True`` ignores the explicit sizes and
factorizes the device count as dp x fsdp with fsdp the largest divisor
<= 8 (one host's ICI domain; dp rides the slower DCN-most axis).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

from ...parallel.mesh import CANONICAL_ORDER, MeshSpec

_AXIS_RE = re.compile(r"^(dp|fsdp|tp|sp|ep|pp)(-1|\d+)$")

#: Largest per-host axis the auto factorization assigns to fsdp.
_AUTO_FSDP_MAX = 8


@dataclass
class MeshConfig:
    """Mesh shape for the train worker group (``ScalingConfig.mesh_config``).

    ``devices_per_worker`` is the per-process device count.  A process of
    the port holds one card (or is one CPU rank), so the trainer refuses
    any other value (``train.controller``); the resolution arithmetic
    below keeps JAX's meaning for it.  ``rules`` overrides logical-axis sharding
    rules by name (e.g. ``{"embed": "tp"}``) on top of
    ``parallel.sharding.default_rules``.
    """
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    devices_per_worker: int = 1
    auto: bool = False
    rules: Optional[Dict[str, object]] = None

    @classmethod
    def parse(cls, text: str, devices_per_worker: int = 1) -> "MeshConfig":
        """``"dp2xfsdp4"`` / ``"fsdp8"`` / ``"auto"`` -> MeshConfig."""
        text = (text or "").strip().lower()
        if text in ("auto", ""):
            return cls(auto=True, devices_per_worker=devices_per_worker)
        sizes: Dict[str, int] = {}
        for token in text.split("x"):
            m = _AXIS_RE.match(token)
            if m is None:
                raise ValueError(
                    f"bad mesh axis token {token!r} in {text!r} "
                    f"(expected e.g. dp2xfsdp4, axes "
                    f"{'/'.join(CANONICAL_ORDER)})")
            axis, size = m.group(1), int(m.group(2))
            if axis in sizes:
                raise ValueError(f"mesh axis {axis!r} repeated in {text!r}")
            sizes[axis] = size
        return cls(devices_per_worker=devices_per_worker, **sizes)

    def axis_sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp,
                "sp": self.sp, "ep": self.ep, "pp": self.pp}

    # -- resolution ---------------------------------------------------------

    def spec_for(self, total_devices: int,
                 num_slices: int = 1) -> MeshSpec:
        """Resolve to a concrete MeshSpec over ``total_devices`` (raises
        ValueError when the shape cannot tile them)."""
        if total_devices < 1:
            raise ValueError(f"total_devices must be >= 1, got "
                             f"{total_devices}")
        if self.auto:
            spec = _auto_spec(total_devices, num_slices)
        else:
            spec = MeshSpec(num_slices=num_slices,
                            **self.axis_sizes()).resolved(total_devices)
        if num_slices > 1 and spec.dp % num_slices:
            raise ValueError(
                f"dp axis ({spec.dp}) must be divisible by num_slices "
                f"({num_slices}): the outermost dp axis maps slice-major "
                f"onto the DCN fabric")
        return spec

    def valid_world(self, num_workers: int, num_slices: int = 1) -> bool:
        """Can a group of ``num_workers`` processes tile this mesh?"""
        if num_workers < 1:
            return False
        try:
            self.spec_for(num_workers * self.devices_per_worker,
                          num_slices)
        except ValueError:
            return False
        return True

    def nearest_valid_world(self, target: int, floor: int = 1,
                            ceiling: Optional[int] = None,
                            num_slices: int = 1) -> Optional[int]:
        """Largest valid world size <= ``target`` (>= ``floor``); when no
        smaller world tiles the mesh, the smallest valid one in
        (target, ceiling].  None when nothing in range is valid.

        This is what keeps elastic sizing from forming a group the mesh
        cannot tile: a drain that would leave 3 workers on a
        fsdp-even mesh downsizes to 2 instead.
        """
        for w in range(min(target, ceiling or target), floor - 1, -1):
            if self.valid_world(w, num_slices):
                return w
        if ceiling is not None:
            for w in range(target + 1, ceiling + 1):
                if self.valid_world(w, num_slices):
                    return w
        return None

    def validate_scaling(self, scaling) -> None:
        """Fail fast at trainer construction when the configured worker
        range contains no world size this mesh can tile."""
        if self.devices_per_worker < 1:
            raise ValueError("devices_per_worker must be >= 1")
        num_slices = getattr(scaling, "num_slices", 1)
        if getattr(scaling, "elastic", False):
            lo = scaling.min_workers or 1
            hi = scaling.max_workers or max(scaling.num_workers, lo)
            if self.nearest_valid_world(hi, floor=lo,
                                        num_slices=num_slices) is None:
                raise ValueError(
                    f"mesh {self.axis_sizes()} (x{self.devices_per_worker} "
                    f"devices/worker) tiles no world size in "
                    f"[{lo}, {hi}]")
        else:
            # Raises with the tiling arithmetic when invalid.
            self.spec_for(scaling.num_workers * self.devices_per_worker,
                          num_slices)

    def sharding_rules(self):
        """default_rules() with this config's per-logical-name overrides."""
        return rules_with_overrides(self.rules)


def rules_with_overrides(overrides: Optional[Dict[str, object]]):
    """default_rules() + per-logical-name overrides — the ONE merge
    implementation shared by MeshConfig and the worker TrainContext
    (ranks resolving rules differently would shard differently)."""
    from ...parallel.sharding import default_rules
    rules = default_rules()
    if overrides:
        rules = rules.replace(**{k: _as_axes(v)
                                 for k, v in overrides.items()})
    return rules


def _as_axes(v):
    """JSON/env-safe rule values: lists arrive where tuples are meant."""
    return tuple(v) if isinstance(v, list) else v


def _auto_spec(total_devices: int, num_slices: int) -> MeshSpec:
    """dp x fsdp factorization: fsdp = largest divisor <= 8 (ICI-sized),
    dp absorbs the rest (and must carry the slice axis when
    num_slices > 1)."""
    fsdp = 1
    for cand in range(min(_AUTO_FSDP_MAX, total_devices), 0, -1):
        if total_devices % cand == 0:
            # dp must stay divisible by num_slices for the DCN mapping.
            if num_slices > 1 and (total_devices // cand) % num_slices:
                continue
            fsdp = cand
            break
    return MeshSpec(dp=total_devices // fsdp, fsdp=fsdp,
                    num_slices=num_slices)
