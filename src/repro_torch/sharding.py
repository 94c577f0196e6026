"""Row sharding of the fleet registry's slab over a ``FleetMesh``.

The counterpart of the reference's ``slab_shardings``: where the JAX
package places one global ``[N, m]`` array with a row-sharded
``NamedSharding``, the port keeps one tensor per shard, shard ``i``
holding slots ``[i * N/d, (i + 1) * N/d)`` on ``mesh.devices[i]``.  So
slot ``s`` lives on shard ``s // (N/d)`` at local row ``s % (N/d)``, as
in the reference.

``send_to`` / ``arrive`` move a tensor between the mesh's devices for
the rings (the all-pairs ring of ``kernels.ops`` and the digest ring of
``fleet.transport.mesh``): a copy between cards on side streams, one
event a copy, which the consumer's stream waits on; nothing at all where
the shards share one device.

The model half of the reference module (logical-axis rules, ``shard``,
``use_mesh_rules``) waits for the training stack.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FLEET_AXIS", "arrive", "mark", "send_to", "shard_rows",
           "split_rows", "slot_groups"]

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


# ---------------------------------------------------------------------------
# copies between the mesh's devices (the rings of all-pairs and the digests)
# ---------------------------------------------------------------------------

#: one side stream a card for the ring's copies (created at first use)
_SIDE_STREAMS: dict = {}


def _side_stream(dev: torch.device):
    stream = _SIDE_STREAMS.get(dev)
    if stream is None:
        stream = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return stream


def mark(dev: torch.device):
    """An event at the end of the work queued so far on ``dev``'s current
    stream (None off the card)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def send_to(t: torch.Tensor, dev: torch.device, after=None):
    """``(t on dev, event or None)``.  A tensor already on ``dev`` (one
    card or the CPU for every shard) is returned as it is.  Between two
    cards the copy is queued on both cards' side streams (a copy between
    cards runs on the source card's current stream and fences the
    destination's), after ``after`` (default: all work queued so far on
    the source's current stream); the event marks its end, and the
    consumer waits on it in ``arrive``."""
    if t.device == dev:
        return t, None
    if t.device.type != "cuda" or dev.type != "cuda":
        return t.to(dev), None
    src, dst = _side_stream(t.device), _side_stream(dev)
    if after is None:
        src.wait_stream(torch.cuda.current_stream(t.device))
    else:
        src.wait_event(after)
    with torch.cuda.stream(src), torch.cuda.stream(dst):
        out = t.to(dev, non_blocking=True)
    t.record_stream(src)
    done = torch.cuda.Event()
    done.record(dst)
    return out, done


def arrive(sent, dev: torch.device) -> torch.Tensor:
    """The tensor of ``send_to``, once ``dev``'s current stream has waited
    for its copy; the allocator then keeps the buffer until that stream
    is done with it."""
    t, done = sent
    if done is not None:
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(done)
        t.record_stream(cur)
    return t
