"""Sharding: the fleet registry's rows and the model's logical axes.

Row sharding of the fleet registry's slab over a ``FleetMesh``.

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

The model half is the reference's logical-axis sharding on DTensor.
Every parameter dim carries a logical axis name (``models/params.py``)
and activations are marked at block boundaries with ``shard(x,
names)``.  One rule table (``DEFAULT_RULES``) maps a logical name to a
mesh axis or a tuple of axes; ``logical_to_pspec`` resolves a tensor's
names to a ``PartitionSpec`` with the reference's fallback to
replication where a dim does not divide the axis extent, and with
first-come-wins where two dims would take one axis.  ``placements``
turns a spec into DTensor placements on a ``DeviceMesh`` (``Shard(d)``
on each mesh dim a tensor dim takes, ``Replicate()`` elsewhere), the
counterpart of a ``NamedSharding``.  The active (mesh, rules) pair is
installed with ``use_mesh_rules``: without it ``shard`` returns its
input, and the model sees plain tensors; inside it ``shard``
redistributes a DTensor to its spec (the reference's
``with_sharding_constraint``) and places a plain tensor, by the same
spec, from the same global value on every rank.  ``replicated`` gives a
tensor made inside a forward (positions, masks, running sums) to the
mesh of a DTensor it meets, as a replicated DTensor.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import math
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["DEFAULT_RULES", "FALLBACKS", "FLEET_AXIS", "NamedSharding", "P",
           "PartitionSpec", "arrive", "assign", "axis_sizes", "cumsum",
           "current_mesh", "einsum", "logical_to_pspec", "make_rules", "mark",
           "pad", "param_pspecs", "placed_as", "placements", "redistribute",
           "replicated", "reshape", "send_to", "shard", "shard_rows", "slot_groups",
           "split_rows", "to_local", "use_mesh_rules"]

#: mesh axis the fleet registry shards its peer slab over; kept out of
#: DEFAULT_RULES because the slab is placed by hand, not by logical axes
FLEET_AXIS = "fleet"


# ---------------------------------------------------------------------------
# the model half: logical axes -> mesh axes -> DTensor placements
# ---------------------------------------------------------------------------

# logical axis -> mesh axis (str), tuple of axes, or None (replicate).
# "*_v" names are small vectors (biases/scales): always replicated.
DEFAULT_RULES = {
    # weights
    "vocab": "model",
    "embed": "data",          # FSDP dim
    "q_heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    # experts take the model axis when the count divides it (deepseek);
    # otherwise the per-expert hidden dim picks it up (grok: 8 experts on a
    # 16-wide axis -> expert weights shard over d_ff instead of replicating)
    "expert_mlp": "model",
    "experts": "model",
    "experts_r": None,
    "lora": None,
    "ssm_inner": "model",
    "layers": None,
    "seq_tab": None,
    "conv_v": None,
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": None,           # flips to "model" under sequence parallelism
    "act_embed": None,
    "act_heads": "model",
    "act_kv": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "act_expert_cap": None,
    "act_state": None,
    # decode KV caches: shard the cache SEQ dim over model (kv-head counts
    # rarely divide 16); decode attention contracts over it
    "act_seq_cache": "model",
    "act_kv_cache": None,
    "act_ssm_heads": "model",
}


def make_rules(**overrides) -> dict:
    r = dict(DEFAULT_RULES)
    r.update(overrides)
    return r


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of axis names (the dim split over each, major to minor); a
    tuple of one name is that name, as in the reference."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """``{axis name: extent}`` of a ``DeviceMesh``, or of any object
    whose ``shape`` already is such a mapping."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _axis_extent(sizes: dict, spec_entry) -> int:
    if spec_entry is None:
        return 1
    if isinstance(spec_entry, tuple):
        return math.prod(sizes.get(a, 1) for a in spec_entry)
    return sizes.get(spec_entry, 1)


def _resolve_entry(sizes: dict, rules: dict, name: Optional[str], dim: int):
    """Rule lookup + divisibility fallback (replicate if it doesn't divide)."""
    if name is None:
        return None
    entry = rules.get(name)
    if entry is None:
        return None
    if isinstance(entry, tuple):
        # drop axes missing from this mesh (e.g. "pod" on single-pod)
        entry = tuple(a for a in entry if a in sizes)
        if not entry:
            return None
        if dim % _axis_extent(sizes, entry) != 0:
            # try progressively shorter prefixes
            while entry and dim % _axis_extent(sizes, entry) != 0:
                entry = entry[:-1]
            return entry or None
        return entry
    if entry not in sizes:
        return None
    if dim % sizes[entry] != 0:
        return None
    return entry


def logical_to_pspec(mesh, rules: dict, axes: tuple, shape: tuple) -> P:
    """Logical axes + concrete shape -> PartitionSpec (with fallbacks).

    No mesh axis is used twice in one spec: first-come wins, later dims
    fall back to replication.  Reads only ``mesh.shape``.
    """
    sizes = axis_sizes(mesh)
    used: set = set()
    entries = []
    for name, dim in zip(axes, shape):
        e = _resolve_entry(sizes, rules,
                           name if name and not name.endswith("_v") else None,
                           dim)
        if e is None:
            entries.append(None)
            continue
        flat = e if isinstance(e, tuple) else (e,)
        if any(a in used for a in flat):
            entries.append(None)
            continue
        used.update(flat)
        entries.append(e)
    return P(*entries)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(d)`` on every mesh dim of more than one rank that tensor dim
    ``d``'s entry names, ``Replicate()`` on the others (a shard over one
    rank is the whole tensor).  A dim split over several axes takes them
    major to minor, so the axes must come in the mesh's order."""
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a)
               for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of dim {dim} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def param_pspecs(mesh, rules: dict, table: dict) -> dict:
    """param_table -> {path: NamedSharding}."""
    return {
        path: NamedSharding(mesh, logical_to_pspec(mesh, rules, info.axes,
                                                   info.shape))
        for path, info in table.items()
    }


class _Ctx:
    def __init__(self, mesh, rules: dict):
        self.mesh = mesh
        self.rules = rules


_ACTIVE: contextvars.ContextVar[Optional[_Ctx]] = contextvars.ContextVar(
    "shard_ctx", default=None)


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[dict] = None):
    tok = _ACTIVE.set(_Ctx(mesh, rules or DEFAULT_RULES))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def current_mesh():
    ctx = _ACTIVE.get()
    return ctx.mesh if ctx else None


def _all_replicated(mesh) -> list:
    return [Replicate()] * mesh.ndim


def replicated(t: torch.Tensor, like) -> torch.Tensor:
    """``t``, made alike on every rank, as a replicated DTensor on the
    mesh of ``like`` when ``like`` is a DTensor; else ``t`` itself."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, _all_replicated(mesh), run_check=False)


#: sharded DTensors gathered to run an op on replicated operands, by
#: site (``to_local``'s ``site``); the dry run records and clears it
FALLBACKS: collections.Counter = collections.Counter()


def placed_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``like``'s placements where ``like`` is a
    DTensor, else ``t`` as it is."""
    if isinstance(like, DTensor) and t.placements != like.placements:
        return t.redistribute(like.device_mesh, like.placements)
    return t


def to_local(t, site: str = "op"):
    """The full value of ``t`` on this rank: a DTensor gathered to
    replicated and unwrapped (differentiably), a plain tensor as it is.
    A gather of a tensor sharded over more than one rank counts in
    ``FALLBACKS[site]``."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    if any(not p.is_replicate() and n > 1
           for p, n in zip(t.placements, mesh.shape)):
        FALLBACKS[site] += 1
    return t.redistribute(mesh, _all_replicated(mesh)).to_local()


def assign(buf: torch.Tensor, key, value: torch.Tensor) -> torch.Tensor:
    """``buf[key] = value``; returns the buffer written.  A plain ``buf``
    is written in place and returned.  DTensor has no sharding strategy
    for an in-place write into a slice of a sharded dim, so a DTensor
    ``buf`` is written on replicated operands, as GSPMD writes it: both
    gathered, the write made on this rank's full copy, and the result
    placed as ``buf`` was (in place where ``buf`` was replicated)."""
    if not isinstance(buf, DTensor):
        buf[key] = value
        return buf
    mesh = buf.device_mesh
    full = to_local(buf, "assign")
    full[key] = to_local(value, "assign")
    out = DTensor.from_local(full, mesh, _all_replicated(mesh),
                             run_check=False)
    return out.redistribute(mesh, buf.placements)


#: the views (shape, placements, new shape) DTensor refused, not tried
#: again
_REFUSED: set = set()


def _reshape(x: DTensor, shape) -> DTensor:
    new = torch.empty(x.shape, device="meta").reshape(*shape).shape
    key = (tuple(x.shape), x.placements, tuple(new))
    if key not in _REFUSED:
        try:
            return x.reshape(new)
        except RuntimeError:
            _REFUSED.add(key)
    k = next((i for i, (a, b) in enumerate(zip(x.shape, new)) if a != b),
             min(x.ndim, len(new)))
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim >= k else p
               for p in x.placements)
    if pl != x.placements:
        FALLBACKS["reshape"] += 1
    return x.redistribute(x.device_mesh, pl).reshape(new)


class _Reshape(torch.autograd.Function):
    """``_reshape`` forward, and backward on the gradient (which may
    come back sharded where the output's view could not be undone)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return _reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape(g, ctx.shape), None


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``.  DTensor refuses a view that would split or
    merge a sharded dim unevenly (GSPMD reshards there); such a DTensor,
    or its gradient in the backward, has its dims from the first one the
    view changes gathered first (counted in ``FALLBACKS["reshape"]``)."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def einsum(equation: str, *operands) -> torch.Tensor:
    """``torch.einsum``; on DTensors as a ``local_map``: each mesh dim
    that shards an output letter of some operand shards that letter in
    every operand that has it (a local chunk where one holds it whole),
    every other dim of the mesh is gathered, and each rank runs the
    einsum on its local tensors.  DTensor's own einsum flattens groups
    of dims into views that may hold a sharded dim inside, which it
    splits chunk by chunk (a strided shard) or refuses; the local
    einsum needs no view of a DTensor, and its backward is the local
    einsum's.  A gather of a sharded dim counts in
    ``FALLBACKS["einsum"]``."""
    if not any(isinstance(o, DTensor) for o in operands):
        return torch.einsum(equation, *operands)
    like = next(o for o in operands if isinstance(o, DTensor))
    mesh = like.device_mesh
    ops = [replicated(o, like) for o in operands]
    ins, out = equation.split("->")
    subs = ins.split(",")
    plan = {}                      # mesh dim -> the letter it shards
    for i, n in enumerate(mesh.shape):
        if n == 1:
            continue
        for sub, o in zip(subs, ops):
            p = o.placements[i]
            if isinstance(p, Shard) and sub[p.dim] in out:
                plan[i] = sub[p.dim]
                break
    local = []
    for sub, o in zip(subs, ops):
        pl = tuple(Shard(sub.index(plan[i])) if i in plan and plan[i] in sub
                   else Replicate() for i in range(mesh.ndim))
        if any(isinstance(p, Shard) and p != q
               for p, q in zip(o.placements, pl)):
            FALLBACKS["einsum"] += 1
        local.append(o.redistribute(mesh, pl).to_local())
    y = torch.einsum(equation, *local)
    out_pl = tuple(Shard(out.index(plan[i])) if i in plan else Replicate()
                   for i in range(mesh.ndim))
    if not plan:
        return DTensor.from_local(y, mesh, out_pl, run_check=False)
    size = {c: d for sub, o in zip(subs, ops) for c, d in zip(sub, o.shape)}
    shape = torch.Size(size[c] for c in out)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(y.contiguous(), mesh, out_pl, run_check=False,
                              shape=shape, stride=stride)


def pad(x: torch.Tensor, widths: tuple, value: float = 0.0) -> torch.Tensor:
    """``torch.nn.functional.pad(x, widths, value=value)`` (constant, the
    last dims first).  A DTensor is padded by concatenating replicated
    blocks of ``value``: some DTensor releases pad to a malformed
    placement."""
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(x, widths, value=value)
    for i in range(len(widths) // 2):
        dim = x.ndim - 1 - i
        lo, hi = widths[2 * i], widths[2 * i + 1]
        parts = []
        for n, at in ((lo, 0), (hi, 1)):
            if n:
                shape = list(x.shape)
                shape[dim] = n
                block = torch.full(shape, value, dtype=x.dtype,
                                   device=x.to_local().device)
                parts.append((at, replicated(block, x)))
        if parts:
            x = torch.cat([p for at, p in parts if at == 0] + [x]
                          + [p for at, p in parts if at == 1], dim=dim)
    return x


def _flip(x: DTensor, dim: int) -> DTensor:
    """``x.flip(dim)`` on each rank's local tensor, ``dim`` gathered
    first where it is sharded (some DTensor releases have no strategy
    for ``flip``)."""
    mesh = x.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements)
    x = x.redistribute(mesh, pl)
    return DTensor.from_local(x.to_local().flip(dim), mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


class _Cumsum(torch.autograd.Function):
    """``cumsum`` whose backward is autograd's own (the gradient
    flipped, summed and flipped back) with the flips made locally."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return torch.cumsum(x, dim)

    @staticmethod
    def backward(ctx, g):
        if g.numel() <= 1 or g.shape[ctx.dim] == 1:
            return g, None
        return _flip(torch.cumsum(_flip(g, ctx.dim), ctx.dim), ctx.dim), None


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``, differentiable on DTensors too."""
    if not isinstance(x, DTensor):
        return torch.cumsum(x, dim)
    return _Cumsum.apply(x, dim % x.ndim)


class _Redistribute(torch.autograd.Function):
    """``x.redistribute`` whose backward places the gradient as ``x``
    was, but ``Replicate()`` where ``x`` was ``Partial``: the gradient
    of a sum is each summand's, and some DTensor releases cannot turn a
    sharded gradient back into a partial one."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.back), None


def redistribute(x: DTensor, pl) -> DTensor:
    """``x`` placed by ``pl`` (see ``_Redistribute`` for its backward)."""
    return _Redistribute.apply(x, tuple(pl))


def shard(x: torch.Tensor, axes: tuple):
    """Activation sharding by logical names; the identity without a
    mesh.  A plain tensor is taken as the same global value on every
    rank and placed by the spec (no communication)."""
    ctx = _ACTIVE.get()
    if ctx is None or ctx.mesh is None:
        return x
    mesh = ctx.mesh
    pl = placements(mesh, logical_to_pspec(mesh, ctx.rules, axes, x.shape))
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, _all_replicated(mesh), run_check=False)
    return redistribute(x, pl)


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
