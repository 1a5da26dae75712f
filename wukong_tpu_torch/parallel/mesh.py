"""Shard-slot meshes for the distributed engine.

The JAX package lays the graph's partition axis ("x") over a
``jax.sharding.Mesh`` of devices, one partition per device. The port's
mesh is D shard slots on ONE torch device: every slot's stacked segment
rows, send buffers and tables live on the same card (or, for the tests,
the CPU), and the distributed engine runs each chain step on every slot
before the next step, so an exchange reads every slot's send buffer.

A mesh whose slots would span several devices, and a multi-host launch
(``init_multihost`` with a coordinator), need the multi-process data plane
over ``torch.distributed`` (ROADMAP §A 7b) and raise until it is ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from wukong_tpu_torch.utils.device import resolve_device

MULTI_DEVICE = ("ROADMAP §A 7b: shard slots on several devices, and "
                "multi-host launch, come with the multi-process data plane "
                "over torch.distributed")


@dataclass(frozen=True)
class ShardMesh:
    """D shard slots on one device, over the partition axis ``axis``."""

    n: int
    device: torch.device
    axis: str = "x"

    @property
    def size(self) -> int:
        return self.n


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Multi-host bring-up (the reference's mpiexec rank assignment,
    scripts/run.sh + wukong.cpp:102-104). A no-op when no coordinator is
    given and the environment names none (one host), as in the JAX
    package; with one it raises until the multi-process path is ported."""
    if coordinator is None and "JAX_COORDINATOR_ADDRESS" not in os.environ \
            and "COORDINATOR_ADDRESS" not in os.environ:
        return
    raise NotImplementedError(f"init_multihost: {MULTI_DEVICE}")


def make_mesh(n_shards: int | None = None, devices=None, axis: str = "x",
              device=None) -> ShardMesh:
    """A mesh of ``n_shards`` slots on one device.

    ``devices`` (a list of devices or device names) may repeat one device
    any number of times; it sets the device and, without ``n_shards``, the
    slot count. Otherwise ``device`` does (default ``cuda``: with no GPU
    this raises unless ``device="cpu"`` is passed), and ``n_shards``
    defaults to ``Global.num_workers``."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("make_mesh: empty device list")
        distinct = {resolve_device(d) for d in devs}
        if len(distinct) > 1:
            raise NotImplementedError(
                f"make_mesh over {sorted(map(str, distinct))}: {MULTI_DEVICE}")
        if device is not None and resolve_device(device) not in distinct:
            raise ValueError(f"make_mesh: device {device!r} is not among "
                             f"the devices given")
        dev = distinct.pop()
        if n_shards is None:
            n_shards = len(devs)
    else:
        dev = resolve_device("cuda" if device is None else device)
        if n_shards is None:
            from wukong_tpu_torch.config import Global

            n_shards = Global.num_workers
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"make_mesh: need at least one shard, got {n_shards}")
    return ShardMesh(n=n_shards, device=dev, axis=axis)
