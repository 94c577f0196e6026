"""The meshes: the model's (DTensor) and the fleet's.

The model meshes are ``torch.distributed`` ``DeviceMesh``es over the
ranks of the default process group, which the caller has set up (one
process a rank; on a host with cards the NCCL backend, one card a rank;
gloo on the CPU; the ``"fake"`` backend for the dry run, which is the
counterpart of the reference's forced host devices).
``make_production_mesh`` is (16, 16) ``("data", "model")``, or (2, 16,
16) ``("pod", "data", "model")``, over the group's first 256 or 512
ranks and raises when the group has fewer; ``make_local_mesh`` is a
small (data, model) mesh over the group's ranks, clamped to its size.
Neither sets up a group.

The fleet mesh: the devices a sharded ``ClockRegistry`` spans.

The reference's fleet mesh is a one-axis ``jax.sharding.Mesh`` driven
by one controller: one ``ClockRegistry(mesh=...)`` in one process holds
every row shard.  The port keeps that design.  A ``FleetMesh`` is the
list of torch devices the shards live on, shard ``i`` on
``devices[i]``; one process launches every shard's kernels.  On a host
with several cards these are distinct devices; given ``device=``, every
shard shares that one device (a card, or the CPU for the plain
versions), the counterpart of the reference's forced host platform.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import indexed_device
from repro_torch.sharding import FLEET_AXIS

__all__ = ["FleetMesh", "make_fleet_mesh", "make_local_mesh",
           "make_production_mesh", "mesh_axes"]


def _device_type() -> str:
    """The device type of the default group's ranks: "cuda" where the
    group runs CUDA tensors on NCCL, read from its backend config (the
    backend "nccl", or a config such as "cpu:gloo,cuda:nccl", which a
    group set up without a backend string gets on a host with cards);
    "cpu" under gloo and the fake backend."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the model meshes span the ranks of the default process group; "
            "set one up first (torch.distributed.init_process_group)")
    entries = str(dist.get_backend_config()).split(",")
    return "cuda" if {"nccl", "cuda:nccl"} & set(entries) else "cpu"


def _device_mesh(shape: tuple, axes: tuple) -> DeviceMesh:
    kind = _device_type()
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has {world}")
    return DeviceMesh(kind, torch.arange(n).view(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """Small mesh over the group's ranks (tests / examples)."""
    _device_type()
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _device_mesh((data, model), ("data", "model"))


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
