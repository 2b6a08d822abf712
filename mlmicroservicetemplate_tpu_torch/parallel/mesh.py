"""Sequence-parallel placement: the port's ``('sp',)`` mesh.

Counterpart of the JAX package's ``make_sp_mesh`` / ``_make_1d_mesh`` and
``SeqParallelSet`` (``parallel/mesh.py``).  A placement is a list of
``torch.device``s, one per sequence shard, in ring order.  On the card
each shard has a card of its own; on the CPU every shard sits on the host,
standing in for the forced host devices of the JAX package's tests.
Several shards may share a device.

Only the 1-D placement is ported: data-parallel replicas (``ReplicaSet``,
``REPLICAS``) and the 2-D ``('replica', 'sp')`` mesh are not.
"""

from __future__ import annotations

import logging
from typing import Callable, TypeVar

import numpy as np
import torch

log = logging.getLogger(__name__)
T = TypeVar("T")


def make_sp_devices(device: str, n: int = 0) -> list[torch.device]:
    """The devices of an SP=n placement.  ``cuda``: the first n visible
    cards (0 = all); n past the visible count raises.  ``cpu``: n shards on
    the host (0 = 1)."""
    if n < 0:
        raise ValueError(f"SP must be >= 0, got {n}")
    if device == "cpu":
        devs = [torch.device("cpu")] * max(n, 1)
    elif device == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(f"SP={n} but only {count} devices visible")
        devs = [torch.device("cuda", i) for i in range(n or count)]
    else:
        raise ValueError(f"make_sp_devices: unsupported device {device!r}")
    log.info("sp placement over %d shard(s): %s", len(devs), devs)
    return devs


class SeqParallelSet:
    """Engine placement for sequence-parallel (long-context) serving.

    The JAX contract: batches shard their SEQUENCE axis (axis 1 of [B, S])
    over the shards, the batch axis is not split (one replica), and every
    seq bucket must divide by the shard count."""

    def __init__(self, devices: list[torch.device]):
        if not devices:
            raise ValueError("SeqParallelSet needs at least one device")
        self.devices = list(devices)

    @property
    def n_devices(self) -> int:
        """Shards of the placement (a mesh's device count in the JAX package)."""
        return len(self.devices)

    def seq_multiple(self) -> int:
        return len(self.devices)

    def place_params(self, make: Callable[[torch.device], T]) -> list[T]:
        """One replica per shard, from ``make(device)`` called once per
        distinct device: shards on one device share their replica."""
        made: dict[torch.device, T] = {}
        for dev in self.devices:
            if dev not in made:
                made[dev] = make(dev)
        return [made[dev] for dev in self.devices]

    def place_batch(self, a: np.ndarray) -> list[torch.Tensor]:
        """[B, S] host array -> n sequence shards [B, S / n], each on its
        device."""
        n = len(self.devices)
        if a.ndim < 2 or a.shape[1] % n:
            raise ValueError(f"seq axis of {a.shape} does not divide by {n} shards")
        return [torch.from_numpy(np.ascontiguousarray(part)).to(dev, non_blocking=True)
                for part, dev in zip(np.split(a, n, axis=1), self.devices)]
