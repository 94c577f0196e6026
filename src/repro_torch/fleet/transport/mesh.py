"""MeshCollectiveTransport: the digest exchange as a ring over the fleet mesh.

A mesh-sharded ``ClockRegistry`` already holds the fleet's rows as
``[N/d, m]`` shards, one on each of the mesh's devices, and its
classify and all-pairs kernels run once a shard, so a session over it
moves no row through the host.  What a round needs fleet-wide is the
digest view (clock sums, liveness, §4 bases) of every shard.  This
transport runs that exchange as the reference's ``d - 1``-hop ring
(``src/repro/fleet/transport/mesh.py``): each shard's digest circulates
one hop a step through ``sharding.send_to``, the copy primitive of the
all-pairs ring, and every device assembles the full vectors; the first
device's copy lands on the host in one transfer.  Deltas do not exist
(the slab is authoritative) and push-back is the registry's per-shard
broadcast.

``digest_bytes`` is the inbound ring traffic of one node, computed as
the reference does from the vectors that circulated: ``d - 1`` hops of
one digest shard (float32 sum, bool alive, int32 base a slot).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.fleet.transport.base import Transport
from repro_torch.sharding import arrive, send_to

__all__ = ["MeshCollectiveTransport"]


def _digest_ring(shards, devices) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(sums, alive, base) of every slot on the host, after a ring of
    ``d - 1`` hops in which device i receives, at hop h, the digest of
    shard ``i - h`` from device ``i - 1``.  A shard's digest travels as
    one byte buffer (its float32 sums, bool alive and int32 bases), so a
    hop is one copy."""
    d = len(devices)
    nd = shards[0].sums.shape[0]
    width = 9 * nd
    full = [torch.empty((d, width), dtype=torch.uint8, device=dev)
            for dev in devices]
    held = [(torch.cat([sh.sums.view(torch.uint8),
                        sh.alive.view(torch.uint8),
                        sh.base.reshape(-1).view(torch.uint8)]), None)
            for sh in shards]
    for h in range(d):
        if h:
            held = [send_to(cur[(i - 1) % d], dev)
                    for i, dev in enumerate(devices)]
        cur = [arrive(x, dev) for x, dev in zip(held, devices)]
        for i in range(d):
            full[i][(i - h) % d] = cur[i]
    raw = full[0].cpu().numpy()
    sums = raw[:, :4 * nd].copy().view(np.float32).reshape(-1)
    alive = raw[:, 4 * nd:5 * nd].copy().view(np.bool_).reshape(-1)
    base = raw[:, 5 * nd:].copy().view(np.int32).reshape(-1)
    return sums, alive, base


class MeshCollectiveTransport(Transport):
    name = "mesh"
    authoritative = True

    def __init__(self, registry):
        super().__init__()
        if registry.mesh is None:
            raise ValueError(
                "MeshCollectiveTransport needs a mesh-sharded registry "
                "(ClockRegistry(..., mesh=make_fleet_mesh(...)))")
        self.registry = registry

    def digests(self) -> tuple[dict, int]:
        """Run the round's digest ring and return the replicated fleet
        view ``{peer_id: ClockDigest}`` (crc 0: content keys are never
        consulted on an authoritative fabric) and the measured inbound
        bytes: each of the ``d - 1`` hops delivers one foreign shard of
        every vector."""
        self._begin_round()
        r = self.registry
        sums, alive, base = _digest_ring(r.shards, r.mesh.devices)
        slot_to_pid = {s: pid for pid, s in r._slot_of.items()}
        digs = {}
        for slot in np.flatnonzero(alive):
            pid = slot_to_pid.get(int(slot))
            if pid is None:
                continue
            digs[pid] = wire.ClockDigest(
                peer_id=str(pid), clock_sum=float(sums[slot]),
                base=int(base[slot]), m=r.m, k=r.k, crc=0)
        d = r.n_shards
        ring_bytes = (sum(v.nbytes for v in (sums, alive, base))
                      * (d - 1) // d)
        return digs, ring_bytes

    def pull(self, peer_ids) -> tuple[dict[str, bytes], int]:
        return {}, 0              # the sharded slab is authoritative

    def push(self, peer_ids, frame: bytes) -> int:
        # delivery is the session's registry.broadcast, one write a shard
        return len(frame) * len(peer_ids)
