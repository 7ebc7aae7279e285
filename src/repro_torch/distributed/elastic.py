"""Elastic farm controller: autoscaler targets -> scrub-farm rebuilds.

The paper's pool adds/deletes VM instances with queue depth. A host cannot
conjure cards, but it can (a) resize the *active* set of devices it
dispatches to, releasing cards back to the scheduler, and (b) survive device
loss by rebuilding the farm around failed hardware. Both are modeled here
against the host's device pool.

The pool is a list of devices, and the same device may stand in it more
than once (a pool of CPU devices in the tests, or of one card): the
controller tracks members by their index in the pool, never by device.

Failure model: ``mark_failed(device_index)`` removes a pool entry (as a
health-check would), triggering a rebuild at the next reconcile. The
in-flight batch on a failed device is lost — which is safe end to end,
because the queue lease for that work expires and redelivers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.distributed.scrub_farm import ScrubFarm, cuda_devices
from repro_torch.utils.logging import get_logger

log = get_logger("distributed.elastic")


@dataclass
class MeshEvent:
    t: float
    kind: str  # "resize" | "device-failure" | "alert"
    size: int
    detail: str = ""


class ElasticFarmController:
    def __init__(self, devices: Optional[List[torch.device]] = None, clock=None) -> None:
        self.pool: List[torch.device] = list(devices) if devices is not None else cuda_devices()
        self.healthy: List[bool] = [True] * len(self.pool)
        self.clock = clock
        self.events: List[MeshEvent] = []
        self.active = 0
        self.farm: Optional[ScrubFarm] = None
        self.members: List[int] = []  # pool indices of the active farm
        self.rebuilds = 0

    def _now(self) -> float:
        return self.clock.now() if self.clock else 0.0

    def healthy_indices(self) -> List[int]:
        return [i for i, ok in enumerate(self.healthy) if ok]

    def healthy_devices(self) -> List[torch.device]:
        return [self.pool[i] for i in self.healthy_indices()]

    def mark_failed(self, device_index: int) -> None:
        if self.healthy[device_index]:
            self.healthy[device_index] = False
            self.events.append(MeshEvent(self._now(), "device-failure", device_index))
            if self.farm is not None and self.active > len(self.healthy_indices()):
                # the active farm includes the dead device: force a rebuild
                self.reconcile(self.active)

    def reconcile(self, target_workers: int) -> ScrubFarm:
        """Resize the active farm to min(target, healthy). Returns the farm."""
        avail = self.healthy_indices()
        if not avail:
            # total pool loss: keep the last farm handle and surface an alert —
            # in production this pages the operator; work stays queued (leases
            # simply expire and redeliver when capacity returns)
            self.events.append(MeshEvent(self._now(), "alert", 0, "no healthy devices"))
            if self.farm is None:
                self.farm = ScrubFarm(self.pool[:1])
                self.members = [0]
            return self.farm
        size = max(1, min(target_workers, len(avail)))
        if self.farm is None or size != self.active or any(
            i not in avail for i in self.members
        ):
            self.members = avail[:size]
            self.farm = ScrubFarm([self.pool[i] for i in self.members])
            self.active = size
            self.rebuilds += 1
            self.events.append(MeshEvent(self._now(), "resize", size))
            log.debug("rebuilt farm on %d devices", size)
        return self.farm
