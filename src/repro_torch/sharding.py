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
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["DEFAULT_RULES", "FALLBACKS", "FLEET_AXIS", "NamedSharding", "P",
           "PartitionSpec", "arrive", "assign", "axis_sizes", "cumsum",
           "current_mesh", "einsum", "logical_to_pspec", "make_rules", "mark",
           "pad", "param_pspecs", "placed_as", "placements", "redistribute",
           "replicated", "reshape", "send_to", "shard", "shard_rows", "slot_groups",
           "split_rows", "summed", "to_local", "use_mesh_rules"]

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
    ``FALLBACKS[site]``; a partial sum's reduction (a step's loss
    metric) is no gather and does not count."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    if any(isinstance(p, Shard) and n > 1
           for p, n in zip(t.placements, mesh.shape)):
        FALLBACKS[site] += 1
    return t.redistribute(mesh, _all_replicated(mesh)).to_local()


def assign(buf: torch.Tensor, key, value: torch.Tensor) -> torch.Tensor:
    """``buf[key] = value``; returns the buffer written.  A plain ``buf``
    is written in place and returned, and so is a DTensor ``buf`` whose
    ``key`` is ``...`` (the whole buffer): ``value`` placed as ``buf``
    is and copied into its local tensor, nothing gathered.  DTensor has
    no sharding strategy for an in-place write into a slice of a sharded
    dim, so for any other key a DTensor ``buf`` is written on replicated
    operands, as GSPMD writes it: both gathered, the write made on this
    rank's full copy, and the result placed as ``buf`` was (in place
    where ``buf`` was replicated)."""
    if not isinstance(buf, DTensor):
        buf[key] = value
        return buf
    if key is Ellipsis:
        buf.to_local().copy_(placed_as(replicated(value, buf), buf).to_local())
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


def _dense_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, computed without
    a tensor (the dry run counts every tensor a step creates)."""
    out, step = [], 1
    for d in reversed(tuple(shape)):
        out.append(step)
        step *= max(d, 1)
    return tuple(reversed(out))


def _view_shape(size, shape) -> torch.Size:
    """What ``reshape(*shape)`` of a tensor of ``size`` gives (a -1
    resolved), computed without a tensor."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    known = math.prod(d for d in shape if d != -1)
    return torch.Size(math.prod(size) // known if d == -1 else d
                      for d in shape)


def _reshape(x: DTensor, shape) -> DTensor:
    new = _view_shape(x.shape, shape)
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


def logical_placements(axes: tuple, shape) -> Optional[tuple]:
    """The placements ``shard(x, axes)`` gives a tensor of ``shape`` on
    the active mesh by the active rules; None without a mesh."""
    ctx = _ACTIVE.get()
    if ctx is None or ctx.mesh is None:
        return None
    return placements(ctx.mesh, logical_to_pspec(ctx.mesh, ctx.rules, axes,
                                                 tuple(shape)))


def _einsum_plan(subs: list, out: str, ops: list, mesh) -> dict:
    """{mesh dim: the letter it shards} of ``einsum``: on each mesh dim
    of more than one rank, of the letters some operand shards there, the
    one that gathers the fewest bytes (the operands sharded there by
    another letter are gathered); on a tie an output letter before a
    contracted one, then the first operand's."""
    plan = {}
    for i, n in enumerate(mesh.shape):
        if n == 1:
            continue
        held = []                  # (sub, local bytes, letter sharded)
        for sub, o in zip(subs, ops):
            p = o.placements[i]
            loc = o.to_local()
            held.append((sub, loc.numel() * loc.element_size(),
                         sub[p.dim] if isinstance(p, Shard) else None))
        cands = list(dict.fromkeys(c for _, _, c in held if c is not None))
        if not cands:
            continue

        def cost(c):
            moved = sum(b for _, b, s in held if s is not None and s != c)
            return (moved, c not in out, cands.index(c))
        plan[i] = min(cands, key=cost)
    return plan


def einsum(equation: str, *operands) -> torch.Tensor:
    """``torch.einsum``; on DTensors as a ``local_map``: each mesh dim
    shards one letter of those some operand shards there
    (``_einsum_plan``: the one that gathers least) in every operand
    that has it (a local chunk where one holds it whole), every other
    dim of the mesh is gathered, and each rank runs the einsum on its
    local tensors.  Where the letter is contracted the result is
    ``Partial`` (each rank's sum over its shard of the letter), reduced
    where the next op needs it: decode's ``p . v`` over a seq-sharded
    cache reduces [B, 1, H, Dv] and gathers no cache.  The gradient of
    an operand without the letter is ``Partial`` on that mesh dim.
    DTensor's own einsum flattens groups of dims into views that may
    hold a sharded dim inside, which it splits chunk by chunk (a strided
    shard) or refuses; the local einsum needs no view of a DTensor, and
    its backward is the local einsum's.  A gather of a sharded dim
    counts in ``FALLBACKS["einsum"]``."""
    if not any(isinstance(o, DTensor) for o in operands):
        return torch.einsum(equation, *operands)
    like = next(o for o in operands if isinstance(o, DTensor))
    mesh = like.device_mesh
    ops = [replicated(o, like) for o in operands]
    ins, out = equation.split("->")
    subs = ins.split(",")
    plan = _einsum_plan(subs, out, ops, mesh)
    local = []
    for sub, o in zip(subs, ops):
        pl = tuple(Shard(sub.index(plan[i])) if i in plan and plan[i] in sub
                   else Replicate() for i in range(mesh.ndim))
        if any(isinstance(p, Shard) and p != q
               for p, q in zip(o.placements, pl)):
            FALLBACKS["einsum"] += 1
        # an operand without the letter a mesh dim shards meets only
        # this rank's part of it: its gradient is a partial sum there
        grad = tuple(Partial() if i in plan and plan[i] not in sub else p
                     for i, p in enumerate(pl))
        local.append(o.redistribute(mesh, pl).to_local(grad_placements=grad))
    y = torch.einsum(equation, *local)
    out_pl = tuple(Replicate() if i not in plan
                   else Shard(out.index(plan[i])) if plan[i] in out
                   else Partial() for i in range(mesh.ndim))
    if not plan:
        return DTensor.from_local(y, mesh, out_pl, run_check=False)
    size = {c: d for sub, o in zip(subs, ops) for c, d in zip(sub, o.shape)}
    shape = torch.Size(size[c] for c in out)
    return DTensor.from_local(y.contiguous(), mesh, out_pl, run_check=False,
                              shape=shape, stride=_dense_stride(shape))


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


def _owned(y: DTensor, x: DTensor) -> DTensor:
    """``y``, ``x`` placed anew: its local shard copied out where it is a
    view into a storage of more than twice its bytes (a chunk of a whole
    gathered or replicated on this rank), so that the whole can be
    freed.  ``y`` as it is when the placements did not change."""
    loc = y.to_local()
    if (y.placements == x.placements
            or loc.untyped_storage().nbytes() <= 2 * loc.nbytes):
        return y
    return DTensor.from_local(loc.clone(memory_format=torch.contiguous_format),
                              y.device_mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


class _Redistribute(torch.autograd.Function):
    """``x.redistribute`` whose backward places the gradient as ``x``
    was, but ``Replicate()`` where ``x`` was ``Partial``: the gradient
    of a sum is each summand's, and some DTensor releases cannot turn a
    sharded gradient back into a partial one.  Both directions keep no
    gathered whole alive behind a shard (``_owned``)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return _owned(x.redistribute(x.device_mesh, pl), x)

    @staticmethod
    def backward(ctx, g):
        return _owned(g.redistribute(g.device_mesh, ctx.back), g), None


def redistribute(x: DTensor, pl) -> DTensor:
    """``x`` placed by ``pl`` (see ``_Redistribute`` for its backward)."""
    return _Redistribute.apply(x, tuple(pl))


def summed(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its partial sums reduced: a DTensor ``Partial`` on some
    mesh dim (a block's output whose products each rank summed over its
    shard) redistributed to ``Replicate()`` there; any other tensor as
    it is.  A residual add reduces the block's output first: DTensor
    adds a replicated tensor to a partial sum by halving it on each
    rank, a rounding in each summand that the plain path does not
    make."""
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    return redistribute(t, [Replicate() if p.is_partial() else p
                            for p in t.placements])


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


# ---------------------------------------------------------------------------
# the model axis's explicit collectives: the local_maps that split the
# heads (models.attention, models.ssm) and the vocab (the lookup)
# ---------------------------------------------------------------------------

def model_axis(mesh) -> tuple:
    """(mesh dim index of "model", its size, this rank on it); (None, 1,
    0) where the mesh has no model axis."""
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names:
        return None, 1, 0
    i = names.index("model")
    return i, mesh.size(i), mesh.get_local_rank("model")


def model_split(x) -> bool:
    """Whether ``x`` is a DTensor under the model mesh whose model axis
    has more than one rank (the head-split blocks run there; on a model
    axis of one rank every head is local, and the blocks' DTensor ops
    gather nothing)."""
    mesh = current_mesh()
    return (isinstance(x, DTensor) and mesh is not None
            and model_axis(mesh)[1] > 1)


def dp_axes(mesh, batch: int):
    """The mesh's dp axes ("pod", "data") that shard a batch of
    ``batch``, or None where the batch does not divide their extent (the
    batch is then replicated, as in the reference)."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    if batch % max(1, math.prod(sizes[a] for a in dp)) or not dp:
        return None
    return dp


def head_range(n_heads: int, size: int, rank: int) -> tuple[int, int]:
    """Heads [h0, h1) of ``rank`` when ``n_heads`` split over ``size``
    ranks as ``torch.chunk`` (and DTensor's ``Shard``) splits a dim:
    ceil(n_heads / size) a rank, the last ranks short or empty."""
    c = -(-n_heads // size)
    h0 = min(n_heads, rank * c)
    return h0, min(n_heads, h0 + c)


def summed_grads(mesh, pl, dims=None) -> tuple:
    """The gradient placements of a ``local_map`` input placed ``pl``
    whose local use on each rank is one summand: ``Partial`` where it is
    replicated (on the mesh dims ``dims`` only, where given: on the
    others every rank's use is the whole one)."""
    return tuple(Partial() if q.is_replicate() and n > 1
                 and (dims is None or i in dims) else q
                 for i, (q, n) in enumerate(zip(pl, mesh.shape)))


def exchange(t: torch.Tensor, own: list, dim: int, seq: int | None,
             group) -> torch.Tensor:
    """This rank's owned heads ``t`` [B, S, n_own, ...] (head dim
    ``dim``) made whole over the model group, where rank s owns
    ``own[s]`` heads in rank order: with ``seq`` the group's ranks, rank
    j receives seq chunk j of every rank's heads ([B, S / seq, sum(own),
    ...]); without it every rank receives all of them.  One
    ``all_to_all_single`` (functional, with autograd)."""
    M = len(own)
    if seq:
        parts = t.unflatten(1, (M, t.shape[1] // M)).movedim(1, 0)
    else:
        parts = t.unsqueeze(0).expand((M,) + tuple(t.shape))
    shape = list(parts.shape[1:])
    shape[dim] = 1
    row = math.prod(shape)                 # elements of one head a part
    got = fc.all_to_all_single_autograd(
        parts.contiguous().reshape(-1), [row * n for n in own],
        [parts[0].numel()] * M, group)
    pieces = []
    for n, piece in zip(own, got.split([row * n for n in own])):
        shape[dim] = n
        pieces.append(piece.view(shape))
    return torch.cat(pieces, dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce_sum``'s forward and backward."""

    @staticmethod
    def forward(ctx, x, group, sum_grads):
        ctx.group, ctx.sum_grads = group, sum_grads
        return fc.wait_tensor(fc.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = fc.wait_tensor(fc.all_reduce(g.contiguous(), "sum",
                                             ctx.group))
        return g, None, None


def all_reduce_sum(x: torch.Tensor, group, *,
                   sum_grads: bool) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks (a functional all-reduce)
    with autograd.  ``sum_grads``: each rank then uses the sum in its own
    way (the gated norm's mean of squares over the heads' channels), so
    the backward sums the ranks' gradients too; without it the sum is
    one value replicated over the group (the vocab shards' lookups), so
    each rank's gradient is already the whole one and passes on."""
    return _AllReduceSum.apply(x, group, sum_grads)


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
