"""Card reservation: gang-reserve every card of a host (the counterpart of
``ray_tpu/util/tpu.py``'s slice reservation).

JAX reserves a pod slice as a placement group of one bundle per TPU host,
each holding that host's chips.  Here a host's cards take the place of a
slice host's chips: ``get_num_tpu_chips_per_host`` becomes
``get_num_cards_per_host``, ``get_tpu_worker_resources`` becomes
``get_card_worker_resources`` and ``slice_placement_group`` becomes
``card_placement_group``, a placement group of one bundle per host holding
all of that host's cards.  The port runs on one host, so that is one
bundle; more hosts raise, naming ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .._scheduler import (PlacementGroup, placement_group,
                          remove_placement_group)
from ..accelerators.cuda import CUDAAcceleratorManager

MULTI_HOST = 'ROADMAP Queue 1 item 13, "multi-node cluster"'


def _one_host(num_hosts: int) -> None:
    if num_hosts != 1:
        raise NotImplementedError(
            f"{num_hosts} hosts: the port runs on one host; a reservation "
            f"across hosts is not ported yet ({MULTI_HOST})")


def get_num_cards_per_host() -> int:
    """The cards this host advertises (``CUDAAcceleratorManager``)."""
    return CUDAAcceleratorManager.detect_num_chips()


def get_card_worker_resources(num_hosts: int = 1) -> List[Dict[str, float]]:
    """One bundle per host, each holding all of its cards."""
    _one_host(num_hosts)
    return [{"GPU": float(get_num_cards_per_host())}]


@dataclass
class CardPlacementGroup:
    """The cards of ``num_hosts`` hosts, reserved (JAX:
    ``SlicePlacementGroup``)."""

    num_hosts: int = 1
    placement_groups: List[PlacementGroup] = field(default_factory=list)

    @property
    def cards_per_host(self) -> int:
        return get_num_cards_per_host()

    @property
    def total_hosts(self) -> int:
        return self.num_hosts

    @property
    def accelerator_type(self) -> Optional[str]:
        return CUDAAcceleratorManager.accelerator_type()

    def ready(self, timeout: Optional[float] = 60.0) -> bool:
        return all(pg.ready(timeout=timeout) for pg in self.placement_groups)

    def remove(self) -> None:
        for pg in self.placement_groups:
            remove_placement_group(pg)
        self.placement_groups = []


def card_placement_group(num_hosts: int = 1,
                         strategy: str = "STRICT_SPREAD"
                         ) -> CardPlacementGroup:
    """Reserve every card of ``num_hosts`` hosts (JAX:
    ``slice_placement_group``)."""
    bundles = get_card_worker_resources(num_hosts)
    return CardPlacementGroup(
        num_hosts=num_hosts,
        placement_groups=[placement_group(bundles, strategy=strategy)])
