"""Mixture-of-Experts FFN: the gather path.

The JAX package's ``moe_impl = "gather"`` formulation over the global
token view: top-k routing -> sort token-slots by expert -> a
capacity-bounded bucket per expert (E, C, D) -> batched expert matmuls
-> the gate-weighted combine.  Overflow tokens are dropped (capacity
factor), the standard load-balance auxiliary loss is returned, and the
shared experts are a dense MLP beside the routed ones.
``moe_replicas > 1`` stores physical copies of each expert, routed
round-robin by token, as in the reference.

What the reference writes as scatter-adds is written here as what they
compute, in the reference's order:

- **Top-k.**  ``jax.lax.top_k`` gives ties to the lower expert id;
  ``torch.topk`` does not, so the gates are the first k columns of a
  stable descending ``torch.sort``.
- **Dispatch.**  Each kept slot has a destination row of its own (its
  rank in its expert is below C), and a dropped slot adds zeros, so a
  bucket row is its slot's token or zeros: one gather of the tokens by
  each row's source, no accumulation and no [T * k, D] rows.
- **Combine.**  The reference's scatter-add visits the slots grouped by
  ascending physical expert id and rounds to the output dtype after
  each update.  A token's k slots have distinct experts, so the combine
  adds each token's k contributions in ascending expert order, one
  [T, D] gather, scale and mask a slot, each sum rounded to the
  compute dtype: bit for bit the reference's sums, and deterministic on
  the card (``index_add_`` sums in float32 and uses atomics there).  A
  recomputed forward (remat) routes and sums exactly as the first.

Under the model mesh (``sharding.use_mesh_rules``) the gather path runs
on DTensors, as the reference's runs under ``pjit``.  Where the model
axis has more than one rank and splits the experts or their hidden
dim, ``_moe_on_shards`` runs the experts on their shards as a
``local_map``: each rank routes the global token view, builds only its
experts' buckets (or, where the experts do not divide the axis, runs
its slice of their hidden dim), combines what it computed into a
partial sum and one all-reduce over the model axis adds them.
Elsewhere (one rank, or expert leaves replicated over the axis) the
token bookkeeping runs replicated and the expert matmuls on the
sharded expert weights (``_moe_gather``).  With
``moe_impl = "alltoall"`` and a mesh that divides the experts and the
tokens, ``_moe_alltoall`` takes the reference's expert-parallel
``shard_map`` path as a ``local_map``: tokens are sharded over the dp
axes and the model axis, each rank routes only its own tokens, and two
functional all-to-alls over the model axis (differentiable) move each
expert's buckets to the rank that holds the expert and the results
back.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as fc
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, sub

__all__ = ["moe_ffn"]


def _top_k_gates(logits: torch.Tensor, k: int):
    """softmax-renormalized top-k gates. logits [T, E] -> (gates [T,k], idx [T,k])."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :k], dim=-1), idx[:, :k]


def _aux_loss(logits: torch.Tensor, idx: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * <fraction routed> . <router prob>."""
    probs = torch.softmax(logits.float(), dim=-1)            # [T, E]
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], n_experts).float().mean(0)
    return n_experts * (me * ce).sum()


def _phys_idx(idx: torch.Tensor, replicas: int) -> torch.Tensor:
    """Map logical expert ids -> physical slots (round-robin by token)."""
    if replicas == 1:
        return idx
    T, k = idx.shape
    dev = idx.device
    rep = (torch.arange(T, device=dev)[:, None]
           + torch.arange(k, device=dev)[None, :]) % replicas
    return idx * replicas + rep


def _dispatch_indices(idx: torch.Tensor, T: int, k: int, E: int, C: int):
    """Routing bookkeeping.

    Returns (slot_token [T*k], slot_expert [T*k], rank_in_expert [T*k],
    keep [T*k], order [T*k]) with slots sorted by expert; ``order`` maps
    a sorted slot to its token-major slot (token * k + j).
    """
    dev = idx.device
    slot_expert = idx.reshape(-1)
    order = torch.sort(slot_expert, stable=True).indices
    slot_expert_s = slot_expert[order]
    slot_token_s = order // k
    first = torch.searchsorted(slot_expert_s,
                               torch.arange(E, device=dev, dtype=slot_expert_s.dtype),
                               side="left")
    rank = torch.arange(T * k, device=dev) - first[slot_expert_s]
    keep = rank < C
    return slot_token_s, slot_expert_s, rank, keep, order


def _expert_hidden(cfg: ModelConfig, xe: torch.Tensor, w_gate, w_up,
                   groups=()) -> torch.Tensor:
    """silu(xe @ w_gate) * (xe @ w_up) of each expert, xe [E, C, D];
    with ``groups`` (xe and the weights hold a shard of d_model) each
    product summed over them first."""
    dt = cfg.compute_dtype

    def proj(w):
        p = torch.bmm(xe, w.to(dt))
        for g in groups:
            p = SH.all_reduce_sum(p, g, sum_grads=True)
        return p
    h = F.silu(proj(w_gate))
    return h * proj(w_up)


def _expert_mlp(cfg: ModelConfig, xe: torch.Tensor, w_gate, w_up,
                w_down) -> torch.Tensor:
    """xe [E, C, D] through each expert's gated MLP."""
    return torch.bmm(_expert_hidden(cfg, xe, w_gate, w_up),
                     w_down.to(cfg.compute_dtype))


def _route(cfg: ModelConfig, x2d: torch.Tensor, router, E_phys: int,
           C: int):
    """Routing over the tokens ``x2d`` [T, D]: returns ((tok, dest,
    keep, gate_of_slot), aux), the slots sorted by expert, ``dest`` a
    slot's row of the flat [E_phys * C, D] bucket."""
    dt = cfg.compute_dtype
    T = x2d.shape[0]
    k = cfg.top_k
    logits = x2d @ router.to(dt)
    gates, idx = _top_k_gates(logits, k)
    aux = _aux_loss(logits, idx, cfg.n_experts)
    idx_phys = _phys_idx(idx, cfg.moe_replicas)
    tok, exp, rank, keep, order = _dispatch_indices(idx_phys, T, k, E_phys, C)
    dest = exp * C + torch.clamp(rank, max=C - 1)
    return (tok, dest, keep, gates.reshape(-1)[order]), aux


def _bucket(x2d: torch.Tensor, tok: torch.Tensor, dest: torch.Tensor,
            keep: torch.Tensor, rows: int, lo: int | None = None
            ) -> torch.Tensor:
    """The flat bucket's ``rows`` rows (from row ``lo`` on where given,
    else all of them): each row the token of the kept slot whose
    ``dest`` it is, zeros where no slot fills it.  One gather of the
    tokens by each row's source, the empty rows zeroed in place.  The
    dropped slots (and those outside the rows) name a scratch source
    past them, cut off (no boolean mask: that would wait for the
    card)."""
    T = x2d.shape[0]
    own = keep
    if lo is not None:
        own = keep & (dest >= lo) & (dest < lo + rows)
        dest = dest - lo
    into = torch.where(own, dest, rows)
    src = torch.full((rows + 1,), T, dtype=tok.dtype, device=tok.device)
    src = src.index_copy(0, into, tok)[:-1]
    xe = x2d[torch.clamp(src, max=T - 1)]
    return xe.masked_fill_((src == T)[:, None], 0)


def _route_and_bucket(cfg: ModelConfig, x2d: torch.Tensor, router,
                      E_phys: int, C: int):
    """Routing and the expert buckets: returns (xe [E_phys * C, D],
    (tok, dest, keep, gate_of_slot), aux)."""
    slots, aux = _route(cfg, x2d, router, E_phys, C)
    return _bucket(x2d, *slots[:3], E_phys * C), slots, aux


def _combine(x2d_shape, dt, ye_flat: torch.Tensor, tok: torch.Tensor,
             dest: torch.Tensor, keep: torch.Tensor,
             gate_of_slot: torch.Tensor, *, rows: tuple | None = None,
             lo: int | None = None) -> torch.Tensor:
    """y[t] = sum over t's slots, in sorted-slot order, of
    keep * ye[dest] * gate, rounded to ``dt`` after each add (see the
    module docstring): one [T, D] a slot of each token, gathered,
    scaled and masked.  ``rows``: (r0, r1), only those tokens' sums;
    ``lo``: ``ye_flat`` holds bucket rows [lo, lo + len(ye_flat)) only,
    and the slots outside them add nothing (a rank's own experts: a
    partial sum)."""
    T = x2d_shape[0]
    # the sorted slots of each token, in sorted order: [T, k]
    per_token = torch.sort(tok, stable=True).indices.view(T, -1)
    if rows is not None:
        per_token = per_token[rows[0]:rows[1]]
    d, use = dest[per_token], keep[per_token]
    n = ye_flat.shape[0]
    if lo is not None:
        d = d - lo
        use = use & (d >= 0) & (d < n)
        d = torch.clamp(d, 0, n - 1)
    # an unused slot's gate is 0: its ye row (finite) adds a zero of
    # either sign, which leaves every sum as the mask would
    gate = (gate_of_slot[per_token] * use).unsqueeze(-1)
    y = torch.zeros((per_token.shape[0],) + tuple(x2d_shape[1:]), dtype=dt,
                    device=ye_flat.device)
    # a slot's columns taken once (a host op each counts in decode)
    for dj, gj in zip(d.unbind(1), gate.unbind(1)):
        y = y + (ye_flat[dj] * gj).to(dt)
    return y


def _capacity(cfg: ModelConfig, T: int, E_phys: int) -> int:
    """Slots an expert holds: the reference's expression, in its order."""
    return max(1, int(cfg.capacity_factor * T * cfg.top_k / E_phys))


def _moe_gather(params: dict, cfg: ModelConfig, x2d: torch.Tensor):
    """The sort-gather-combine formulation over the global token view.
    Where the model axis has more than one rank and splits the experts
    or their hidden dim, the experts run on their shards
    (``_moe_on_shards``).  Elsewhere under a mesh the
    routing, the dispatch and the combine (sort, ``searchsorted``,
    index copies and gathers: ops without a DTensor sharding strategy)
    run on replicated operands, this rank's full copy, and the expert
    matmuls on the sharded expert weights."""
    if _experts_split(params, cfg, x2d):
        return _moe_on_shards(params, cfg, x2d)
    T = x2d.shape[0]
    E_phys = cfg.n_experts * cfg.moe_replicas
    C = _capacity(cfg, T, E_phys)
    xe, (tok, dest, keep, gate), aux = _route_and_bucket(
        cfg, SH.to_local(x2d, "moe"), SH.to_local(params["router"], "moe"),
        E_phys, C)
    ye = _expert_mlp(cfg, SH.replicated(xe, x2d).view(E_phys, C, -1),
                     params["w_gate"], params["w_up"], params["w_down"])
    y = _combine(x2d.shape, x2d.dtype,
                 SH.to_local(ye, "moe").view(E_phys * C, -1),
                 tok, dest, keep, gate)
    return SH.replicated(y, x2d), SH.replicated(aux, x2d)


def _experts_split(params: dict, cfg: ModelConfig, x2d) -> bool:
    """Whether the model axis has more than one rank and divides the
    physical experts or shards their hidden dim (``w_gate``'s last)."""
    if not SH.model_split(x2d):
        return False
    mi, M, _ = SH.model_axis(x2d.device_mesh)
    w = SH.replicated(params["w_gate"], x2d)
    return ((cfg.n_experts * cfg.moe_replicas) % M == 0
            or w.placements[mi] == Shard(2))


def _shard_range(n: int, mesh, pl, dim: int = 0) -> tuple[int, int]:
    """[a, b) of this rank's shard of dim ``dim`` (of length ``n``) of a
    tensor placed ``pl`` (``Shard(dim)`` on some mesh dims, in mesh
    order, each split as ``torch.chunk`` splits)."""
    a0 = 0
    for i, p in enumerate(pl):
        if p == Shard(dim):
            a, b = SH.head_range(n, mesh.size(i), mesh.get_local_rank(i))
            a0, n = a0 + a, b - a
    return a0, a0 + n


def _moe_on_shards(params: dict, cfg: ModelConfig, x2d: torch.Tensor):
    """The gather path on a mesh whose model axis has more than one rank
    and splits the experts or their hidden dim (``_experts_split``): a
    ``local_map`` that runs the experts on their shards.  Every rank routes the replicated global token
    view, so that capacity C and the drops are the reference's on each.
    Where the expert leaves shard their hidden dim over the model axis
    (the experts do not divide it: grok-1) a rank keeps the whole bucket
    and runs its slice of that dim, so ye is a partial sum over the
    axis; else the axis divides the experts, and its rank r takes its
    shard of them and builds only their buckets, E_phys / model * C
    rows.  Either way it combines only what it
    computed into a partial sum (no [T * k, D] slab, ye never made
    whole), and one all-reduce over the model axis adds them.  The
    expert leaves' d_model shard (FSDP, one dp axis) is gathered where
    the bucket's gate and up outputs are the larger (train, prefill);
    where the three weights are (2 C < 3 D: decode), each rank
    contracts its d_model shard of the bucket, the gate and up outputs
    are all-reduced over that axis, and the combined [T, D_loc] is
    gathered over it.  Each rank keeps its rows of ``x2d``'s batch
    shard.  The load-balance loss is the same on every rank and its
    gradient is counted once (one rank's).  Gradients: the tokens' and
    the router's are partial sums over the model axis and the axes that
    shard the rows or d_model; the experts' are placed on the model
    axis and the d_model split as their leaves, partial sums over the
    other row axes.  Returns (y placed as ``x2d``, aux replicated)."""
    mesh = x2d.device_mesh
    mi, M, r = SH.model_axis(mesh)
    T, D = x2d.shape
    E_phys = cfg.n_experts * cfg.moe_replicas
    C = _capacity(cfg, T, E_phys)
    names = ("w_gate", "w_up", "w_down")
    leaves = [SH.replicated(params[k], x2d) for k in ("router",) + names]
    wg_pl = leaves[1].placements
    hidden = wg_pl[mi] == Shard(2)
    e0, e1 = SH.head_range(E_phys, M, r)
    n = E_phys * C if hidden else (e1 - e0) * C
    fsdp = [i for i, p in enumerate(wg_pl) if i != mi and p == Shard(1)]
    split = fsdp[0] if len(fsdp) == 1 and 2 * C < 3 * D else None

    def placed(m_dim, d_dim=None):
        return tuple(Shard(m_dim) if i == mi and m_dim is not None
                     else Shard(d_dim) if i == split and d_dim is not None
                     else Replicate() for i in range(mesh.ndim))

    whole = placed(None)
    m_dims = (2, 2, 1) if hidden else (0, 0, 0)
    w_pl = [placed(m, d) for m, d in zip(m_dims, (1, 1, 2))]
    # the rows each rank keeps: x2d's batch shard
    rows_pl = tuple(Shard(0) if i != mi and p == Shard(0) else Replicate()
                    for i, p in enumerate(x2d.placements))
    rows = _shard_range(T, mesh, rows_pl)
    cols = _shard_range(D, mesh, placed(None, 1), 1)
    # a gradient is a partial sum over the model axis (each rank's
    # experts), the axes that shard the rows (each rank's rows) and the
    # d_model split (each rank's columns)
    summed = {i for i, p in enumerate(rows_pl) if p == Shard(0)} | {mi}
    groups = []
    if split is not None:
        summed.add(split)
        groups = [mesh.get_group(split)]
    own_aux = all(mesh.get_local_rank(i) == 0 for i in summed)

    def local(x_l, router, w_gate, w_up, w_down):
        slots, aux = _route(cfg, x_l, router, E_phys, C)
        lo = None if hidden else e0 * C
        xs = x_l[:, cols[0]:cols[1]]
        h = _expert_hidden(cfg, _bucket(xs, *slots[:3], n, lo).view(
            -1, C, xs.shape[1]), w_gate, w_up, groups)
        # the bucket freed before the expert outputs (without grad)
        ye = torch.bmm(h, w_down.to(cfg.compute_dtype)).view(n, -1)
        h = None
        y = _combine((T, ye.shape[1]), x_l.dtype, ye, *slots,
                     rows=None if groups else rows, lo=lo)
        y = SH.all_reduce_sum(y, mesh.get_group(mi), sum_grads=False)
        for g in groups:
            y = fc.all_gather_tensor_autograd(y, 1, g)[rows[0]:rows[1]]
        return y, aux if own_aux else aux.detach()

    in_pl = (whole, whole, *w_pl)
    y, aux = local_map(
        local, out_placements=(rows_pl, whole), in_placements=in_pl,
        in_grad_placements=tuple(SH.summed_grads(mesh, p, summed)
                                 for p in in_pl),
        device_mesh=mesh, redistribute_inputs=True)(x2d, *leaves)
    return SH.redistribute(y, x2d.placements), aux


def _moe_alltoall(params: dict, cfg: ModelConfig, x2d: torch.Tensor,
                  mesh, dp_axes, ep_axis: str):
    """The expert-parallel path with explicit all-to-alls, a
    ``local_map`` over ``mesh``.

    Tokens are sharded over dp_axes + (ep_axis,): every rank routes only
    its own token shard at its own capacity C_loc, then an all-to-all
    over ep_axis moves the expert buckets to their owners (the expert
    leaves sharded over ep_axis, the router replicated), each rank runs
    its E_loc experts over the buckets of every peer, and a second
    all-to-all brings the results back for the combine.  The gradients
    of the router and the experts are the sums over the token shards
    that used them (``Partial`` where they are replicated).  ``x2d``
    is a DTensor on ``mesh``.  Returns (y placed as ``x2d``, the
    load-balance loss averaged over the token shards)."""
    sizes = SH.axis_sizes(mesh)
    ep = sizes[ep_axis]
    E_phys = cfg.n_experts * cfg.moe_replicas
    if E_phys % ep:
        raise ValueError(f"{E_phys} physical experts over {ep_axis} of {ep}: "
                         "pick moe_replicas so that it divides them")
    E_loc = E_phys // ep
    token_axes = tuple(dp_axes) + (ep_axis,)
    tok_pl = SH.placements(mesh, SH.P(token_axes, None))
    aux_pl = SH.placements(mesh, SH.P(token_axes))
    router_pl = SH.placements(mesh, SH.P(None, None))
    exp_pl = SH.placements(mesh, SH.P(ep_axis, None, None))

    group = mesh.get_group(ep_axis)

    def local(x_loc, router, w_gate, w_up, w_down):
        T_loc, D = x_loc.shape
        C_loc = _capacity(cfg, T_loc, E_phys)
        xe, (tok, dest, keep, gate), aux = _route_and_bucket(
            cfg, x_loc, router, E_phys, C_loc)
        # [ep, E_loc * C_loc, D]: block j to peer j; each rank receives
        # its experts' buckets from every peer, [ep (peers), E_loc, C_loc]
        xe = fc.all_to_all_single_autograd(xe.contiguous(), None, None, group)
        xe = (xe.view(ep, E_loc, C_loc, D).transpose(0, 1)
              .reshape(E_loc, ep * C_loc, D))
        ye = _expert_mlp(cfg, xe, w_gate, w_up, w_down)
        ye = (ye.view(E_loc, ep, C_loc, D).transpose(0, 1)
              .reshape(ep * E_loc * C_loc, D))
        ye = fc.all_to_all_single_autograd(ye, None, None, group)
        y = _combine(x_loc.shape, x_loc.dtype, ye, tok, dest, keep, gate)
        return y, aux[None]

    # plain expert leaves are taken as the same value on every rank
    leaves = [SH.replicated(params[k], x2d)
              for k in ("router", "w_gate", "w_up", "w_down")]
    y, aux = local_map(
        local, out_placements=(tok_pl, aux_pl),
        in_placements=(tok_pl, router_pl, exp_pl, exp_pl, exp_pl),
        in_grad_placements=(tok_pl, SH.summed_grads(mesh, router_pl),
                            *[SH.summed_grads(mesh, exp_pl)] * 3),
        device_mesh=mesh, redistribute_inputs=True)(x2d, *leaves)
    # gathered before the mean: a mean over a sharded dim is a partial
    # average, which some DTensor releases cannot add to a partial sum
    aux = SH.redistribute(aux, [Replicate()] * mesh.ndim).mean()
    return SH.redistribute(y, x2d.placements), aux


def moe_ffn(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
            mesh=None, dp_axes=None, ep_axis: str = "model"):
    """MoE FFN over [B, S, D]. Returns (y, aux_loss). Adds shared
    experts.  ``mesh``: the model mesh (``sharding.current_mesh()``);
    with ``cfg.moe_impl == "alltoall"`` and a mesh whose ``ep_axis``
    divides the physical experts and whose dp axes and ``ep_axis``
    divide the tokens, the all-to-all path runs, else the gather path,
    as in the reference."""
    B, S, D = x.shape
    x2d = SH.reshape(x, B * S, D)
    sizes = {} if mesh is None else SH.axis_sizes(mesh)
    use_a2a = (cfg.moe_impl == "alltoall" and mesh is not None
               and ep_axis in sizes
               and (cfg.n_experts * cfg.moe_replicas) % sizes[ep_axis] == 0
               and (B * S) % (sizes[ep_axis] * max(1, math.prod(
                   sizes[a] for a in (dp_axes or ())))) == 0)
    if use_a2a:
        y2d, aux = _moe_alltoall(params, cfg, x2d, mesh, dp_axes or (),
                                 ep_axis)
    else:
        y2d, aux = _moe_gather(params, cfg, x2d)
    y = SH.reshape(y2d, B, S, D)
    if cfg.n_shared_experts:
        y = y + SH.summed(mlp(sub(params, "shared"), cfg, x))
    return y, aux
