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
(``_moe_gather``).  The reference's ``moe_impl = "alltoall"`` path
(``shard_map`` with an ``all_to_all`` over the model axis) is still to
be ported (``local_map`` with functional collectives; ROADMAP.md queue
1): every call takes the gather path, as the reference does without a
mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def moe_ffn(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """MoE FFN over [B, S, D]. Returns (y, aux_loss). Adds shared experts."""
    B, S, D = x.shape
    y2d, aux = _moe_gather(params, cfg, SH.reshape(x, B * S, D))
    y = SH.reshape(y2d, B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp(sub(params, "shared"), cfg, x)
    return y, aux
