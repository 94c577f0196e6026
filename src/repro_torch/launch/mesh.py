"""The fleet mesh: the devices a sharded ``ClockRegistry`` spans.

The reference's fleet mesh is a one-axis ``jax.sharding.Mesh`` driven
by one controller: one ``ClockRegistry(mesh=...)`` in one process holds
every row shard.  The port keeps that design.  A ``FleetMesh`` is the
list of torch devices the shards live on, shard ``i`` on
``devices[i]``; one process launches every shard's kernels.  On a host
with several cards these are distinct devices; given ``device=``, every
shard shares that one device (a card, or the CPU for the plain
versions), the counterpart of the reference's forced host platform.

The training meshes (``make_production_mesh``, ``make_local_mesh``)
wait for the training stack.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import indexed_device
from repro_torch.sharding import FLEET_AXIS

__all__ = ["FleetMesh", "make_fleet_mesh", "mesh_axes"]


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A one-axis mesh of torch devices; frozen and hashable, so a
    ``CausalPolicy`` carrying it stays hashable."""

    devices: tuple
    axis: str = FLEET_AXIS

    @property
    def shape(self) -> dict:
        """``{axis: shards}``, so ``mesh.shape[axis]`` reads as in the
        reference."""
        return {self.axis: len(self.devices)}


def make_fleet_mesh(shards: int | None = None, axis: str = FLEET_AXIS, *,
                    device=None) -> FleetMesh:
    """One-axis mesh for registry slab sharding (``ClockRegistry(mesh=...)``).

    Without ``device`` it takes the FIRST ``shards`` CUDA devices
    (default: all of them) and raises ``ValueError`` when there are
    fewer, as the reference does; it never falls back to the CPU or to
    sharing a card.  With ``device`` ("cuda:0", "cpu", ...) every one of
    ``shards`` (default 1) shards lives on that one device.
    """
    if device is not None:
        shards = 1 if shards is None else shards
        if shards < 1:
            raise ValueError(f"need shards >= 1, got {shards}")
        dev = indexed_device(device)
        return FleetMesh(devices=(dev,) * shards, axis=axis)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    shards = n if shards is None else shards
    if shards < 1 or shards > n:
        raise ValueError(
            f"need 1 <= shards <= {n} CUDA devices, got {shards}; pass "
            f"device= to place every shard on one device")
    return FleetMesh(devices=tuple(torch.device("cuda", i)
                                   for i in range(shards)), axis=axis)


def mesh_axes(mesh: FleetMesh) -> tuple:
    return tuple(mesh.shape.keys())
