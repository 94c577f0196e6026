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
  rank in its expert is below C), and a dropped slot adds zeros, so the
  bucket is an index copy of the kept rows into zeros: no accumulation.
- **Combine.**  The reference's scatter-add visits the slots grouped by
  ascending physical expert id and rounds to the output dtype after
  each update.  A token's k slots have distinct experts, so the combine
  adds each token's k contributions in ascending expert order, one
  vectorised add a slot, each rounded to the compute dtype: bit for bit
  the reference's sums, and deterministic on the card (``index_add_``
  sums in float32 and uses atomics there).  A recomputed forward (remat)
  routes and sums exactly as the first.

Under the model mesh (``sharding.use_mesh_rules``) the gather path runs
on DTensors, as the reference's runs under ``pjit``: the expert weights
stay sharded and the token bookkeeping runs replicated
(``_moe_gather``).  With ``moe_impl = "alltoall"`` and a mesh that
divides the experts and the tokens, ``_moe_alltoall`` takes the
reference's expert-parallel ``shard_map`` path as a ``local_map``:
tokens are sharded over the dp axes and the model axis, each rank
routes only its own tokens, and two functional all-to-alls over the
model axis (differentiable) move each expert's buckets to the rank
that holds the expert and the results back.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as fc
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate
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


def _expert_mlp(cfg: ModelConfig, xe: torch.Tensor, w_gate, w_up,
                w_down) -> torch.Tensor:
    """xe [E, C, D] through each expert's gated MLP."""
    dt = cfg.compute_dtype
    g = torch.bmm(xe, w_gate.to(dt))
    u = torch.bmm(xe, w_up.to(dt))
    return torch.bmm(F.silu(g) * u, w_down.to(dt))


def _route_and_bucket(cfg: ModelConfig, x2d: torch.Tensor, router,
                      E_phys: int, C: int):
    """Routing and the expert buckets: returns (xe [E_phys * C, D],
    (tok, dest, keep, gate_of_slot), aux)."""
    dt = cfg.compute_dtype
    T, D = x2d.shape
    k = cfg.top_k
    logits = x2d @ router.to(dt)
    gates, idx = _top_k_gates(logits, k)
    aux = _aux_loss(logits, idx, cfg.n_experts)
    idx_phys = _phys_idx(idx, cfg.moe_replicas)
    tok, exp, rank, keep, order = _dispatch_indices(idx_phys, T, k, E_phys, C)
    dest = exp * C + torch.clamp(rank, max=C - 1)
    # dropped slots are copied to a scratch row past the buckets, cut
    # off below (no boolean mask: that would wait for the card)
    into = torch.where(keep, dest, E_phys * C)
    xe = x2d.new_zeros((E_phys * C + 1, D)).index_copy(0, into, x2d[tok])
    xe = xe[:-1]
    gate_of_slot = gates.reshape(-1)[order]
    return xe, (tok, dest, keep, gate_of_slot), aux


def _combine(x2d_shape, dt, ye_flat: torch.Tensor, tok: torch.Tensor,
             dest: torch.Tensor, keep: torch.Tensor,
             gate_of_slot: torch.Tensor) -> torch.Tensor:
    """y[t] = sum over t's slots, in sorted-slot order, of
    keep * ye[dest] * gate, rounded to ``dt`` after each add (see the
    module docstring)."""
    T = x2d_shape[0]
    upd = torch.where(keep[:, None], ye_flat[dest] * gate_of_slot[:, None],
                      0).to(dt)
    # the sorted slots of each token, in sorted order: [T, k]
    per_token = torch.sort(tok, stable=True).indices.view(T, -1)
    y = torch.zeros(x2d_shape, dtype=dt, device=ye_flat.device)
    for j in range(per_token.shape[1]):
        y = y + upd[per_token[:, j]]
    return y


def _capacity(cfg: ModelConfig, T: int, E_phys: int) -> int:
    """Slots an expert holds: the reference's expression, in its order."""
    return max(1, int(cfg.capacity_factor * T * cfg.top_k / E_phys))


def _moe_gather(params: dict, cfg: ModelConfig, x2d: torch.Tensor):
    """The sort-gather-combine formulation over the global token view.
    Under a mesh the routing, the dispatch and the combine (sort,
    ``searchsorted``, index copies and gathers: ops without a DTensor
    sharding strategy) run on replicated operands, this rank's full
    copy, and the expert matmuls on the sharded expert weights."""
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

    def summed(pl):
        return tuple(Partial() if q.is_replicate() and n > 1 else q
                     for q, n in zip(pl, mesh.shape))

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
        in_grad_placements=(tok_pl, summed(router_pl), *[summed(exp_pl)] * 3),
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
        y = y + mlp(sub(params, "shared"), cfg, x)
    return y, aux
