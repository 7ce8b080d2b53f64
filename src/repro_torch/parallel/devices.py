"""Device slots — the fleet's per-worker view of the host's cards.

Counterpart of the JAX package's ``parallel/devices.py``.  A
:class:`repro_torch.tuning.fleet.ShardedPortfolio` race wants one
measurement worker per portfolio member; on a host with several cards each
worker should own one, so members measure concurrently instead of queueing
on card 0.  :func:`local_device_pool` hands out that assignment: one
:class:`DeviceSlot` per worker, round-robin over the process's CUDA cards,
each slot carrying its own partition of a shared
:class:`~repro_torch.core.costs.ExecutableCache` (the same candidate built
for two cards is two distinct entries — partitioned keys keep them from
colliding while the LRU budget and stats stay shared).

On a host with no card the slots have ``device=None`` (shown as ``host``)
and measurement runs on plain host threads: the fleet keeps its concurrency
without device parallelism.  That is a mode of the pool, as in the JAX
package, not a fallback of the kernels: a measurement of a CUDA kernel on
such a host still fails.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

__all__ = ["DeviceSlot", "local_device_pool"]


@dataclasses.dataclass
class DeviceSlot:
    """One fleet worker's execution context: its index, the card it pins
    measurements to (a ``torch.device``; None: the host), and its
    namespaced executable cache."""

    index: int
    device: Optional[Any]
    cache: Optional[Any] = None

    def __str__(self) -> str:
        dev = "host" if self.device is None else str(self.device)
        return f"slot{self.index}[{dev}]"


def local_device_pool(num_slots: int, *, cache=None) -> List[DeviceSlot]:
    """``num_slots`` device slots over the process's CUDA cards,
    round-robin (8 slots on 4 cards → each card serves two workers).  When
    ``cache`` (an :class:`~repro_torch.core.costs.ExecutableCache`) is
    given, every slot gets a per-*card* partition of it, so workers sharing
    a card also share its built candidates."""
    if num_slots < 1:
        raise ValueError(f"num_slots must be >= 1, got {num_slots}")
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    slots = []
    for i in range(num_slots):
        device = torch.device("cuda", i % n) if n else None
        part = None
        if cache is not None:
            part = cache.partition(f"dev{i % n}" if n else "host")
        slots.append(DeviceSlot(index=i, device=device, cache=part))
    return slots
