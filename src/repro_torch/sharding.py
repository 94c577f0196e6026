"""Row sharding of the fleet registry's slab over a ``FleetMesh``.

The counterpart of the reference's ``slab_shardings``: where the JAX
package places one global ``[N, m]`` array with a row-sharded
``NamedSharding``, the port keeps one tensor per shard, shard ``i``
holding slots ``[i * N/d, (i + 1) * N/d)`` on ``mesh.devices[i]``.  So
slot ``s`` lives on shard ``s // (N/d)`` at local row ``s % (N/d)``, as
in the reference.

The model half of the reference module (logical-axis rules, ``shard``,
``use_mesh_rules``) waits for the training stack.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FLEET_AXIS", "shard_rows", "split_rows", "slot_groups"]

#: mesh axis the fleet registry shards its peer slab over
FLEET_AXIS = "fleet"


def shard_rows(slot: int, rows: int) -> tuple[int, int]:
    """(shard, local row) of ``slot`` with ``rows`` slots a shard."""
    return slot // rows, slot % rows


def split_rows(x: torch.Tensor, devices) -> tuple[torch.Tensor, ...]:
    """A ``[N, ...]`` tensor as one ``[N/d, ...]`` tensor a device,
    shard ``i`` a copy on ``devices[i]``, in slot order; raises when
    ``d`` does not divide ``N``."""
    N, d = x.shape[0], len(devices)
    if N % d:
        raise ValueError(f"{N} rows not divisible by {d} shards")
    rows = N // d
    return tuple(x[i * rows:(i + 1) * rows].to(dev, copy=True).contiguous()
                 for i, dev in enumerate(devices))


def slot_groups(slots, rows: int) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """The slots of one batch grouped by owning shard: ``(shard, local
    rows, positions in the batch)`` for each shard that owns at least
    one, in shard order, so that each shard takes one indexed write."""
    slots = np.asarray(slots, np.int64).reshape(-1)
    owner = slots // rows
    out = []
    for shard in np.unique(owner):
        pos = np.flatnonzero(owner == shard)
        out.append((int(shard), slots[pos] % rows, pos))
    return out
