"""Train step construction: loss, grads, AdamW, the clock tick.

The bloom clock rides inside the step as part of ``TrainState`` (m int32
cells): each committed step ticks it with the batch event id, so the
clock is part of the training state — a checkpoint written at step N
carries exactly the causal history of the steps and batches that
produced it, and two checkpoints from diverged runs are provably (Eq. 3)
ordered or provably concurrent.

The JAX package's step, eagerly: gradients by ``torch.autograd`` with
respect to the float32 masters (the flat layout of
``models.params.param_table``, stacked ``layers/...`` when
``cfg.scan_layers``), microbatches as a Python loop (the reference's
``lax.scan``), the chunked loss (``cfg.ce_chunk``) as a loop over
chunks, and the tick through ``core.clock.tick``, which launches the
tick kernel (B = 1, k probes) for a clock on the card.  The step
returns a new ``TrainState``; nothing is compiled (no ``jit``, no
``torch.compile``).

Under the model mesh (``sharding.use_mesh_rules``, masters placed by
``launch.specs.state_shardings``) the step is the reference's SPMD
step on DTensors: the gradients, which arrive ``Partial`` or placed as
the backward left them, are reduced to their master's placement, the
optimizer keeps every leaf's placement, and the clock cells and the
step stay replicated: each rank ticks its own replica, the local
tensor, through the tick kernel (the reference's replicated
``clock_cells``).  The metrics come back as full values on every rank.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import sharding as SH
from repro_torch.core import clock as bc
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state
from repro_torch.runtime.clock_runtime import ClockConfig

__all__ = ["TrainState", "init_train_state", "make_train_step", "cross_entropy"]


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: dict
    clock_cells: torch.Tensor   # int32 [m] — the in-step bloom clock
    step: torch.Tensor          # int32 scalar


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     opt_cfg: OptConfig, clock_cfg: ClockConfig,
                     device=None) -> TrainState:
    """Fresh state on ``device`` (None = the card): params drawn from
    ``generator`` (``models.params.init_params``), zero moments, an
    empty clock, step 0."""
    from repro_torch.models.params import init_params

    params = init_params(generator, cfg, device)
    dev = next(iter(params.values())).device
    return TrainState(
        params=params,
        opt=init_opt_state(params, opt_cfg),
        clock_cells=torch.zeros((clock_cfg.m,), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., label] for every position.  The reference's gather
    fills out-of-range labels; ``torch.gather`` refuses them (a CUDA
    device assert), so the index is clamped here and the callers mask
    those positions out, which gives the same loss and a zero gradient
    there."""
    idx = labels.long().clamp(0, logits.shape[-1] - 1)
    g = torch.gather(logits, -1, idx[..., None])
    if isinstance(g, DTensor):
        # a gather over a vocab-sharded dim is a masked partial sum;
        # reduced here, before the select drops the dim its mask covers
        g = SH.redistribute(g, [Replicate() if p.is_partial() else p
                                for p in g.placements])
    return g[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Stable CE in fp32 with optional z-loss; ignores labels < 0 and
    labels >= vocab."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ce = lse - _gold(lf, labels)
    mask = (labels >= 0) & (labels < vocab)
    denom = torch.clamp(mask.sum(), min=1)
    loss = torch.where(mask, ce, 0.0).sum() / denom
    if z_loss:
        loss = loss + z_loss * torch.where(mask, lse.square(), 0.0).sum() / denom
    return loss


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    clock_cfg: ClockConfig, aux_coef: float = 0.01,
                    num_microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: tokens/labels [B, S] int32 tensors on the state's device,
    ev_hi/ev_lo the uint32 halves of this batch's bloom event id
    (Python ints), optional prefix_embeds, and an enc-dec config's
    enc_frames [B, enc_seq, d_model].  Microbatching (grad
    accumulation) slices the batch dim of every tensor that has it.
    The metrics are 0-d tensors on the device (read them with
    ``float``).
    """
    T.check_ported(cfg)

    def loss_fn(params, batch):
        # the modules are built from the masters inside the
        # differentiated function, so the casts are in the graph
        model = T.build(params, cfg)
        if cfg.ce_chunk:
            # seq-chunked CE: never materialize the full [B, S, V]
            # logits — unembed + logsumexp chunk by chunk (the logits of
            # a chunk are freed before the next chunk is formed)
            hidden, aux = T.forward_hidden(
                model, cfg, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"),
                enc_frames=batch.get("enc_frames"))
            if cfg.n_prefix:
                hidden = hidden[:, cfg.n_prefix:]
            S = hidden.shape[1]
            C = min(cfg.ce_chunk, S)
            pad = (-S) % C
            labels = SH.replicated(batch["labels"], hidden)
            if pad:
                hidden = SH.pad(hidden, (0, 0, 0, pad))
                labels = SH.pad(labels, (0, pad), value=-1)  # masked out
            tot = SH.replicated(torch.zeros((), dtype=torch.float32,
                                            device=hidden.device), hidden)
            cnt = SH.replicated(torch.zeros((), dtype=torch.int32,
                                            device=hidden.device), hidden)
            for i in range((S + pad) // C):
                h = hidden[:, i * C:(i + 1) * C]
                lb = labels[:, i * C:(i + 1) * C]
                logits = model.unembed(h).to(torch.float32)
                lse = torch.logsumexp(logits, dim=-1)
                mask = (lb >= 0) & (lb < cfg.vocab)
                ce = torch.where(mask, lse - _gold(logits, lb)
                                 + 1e-4 * lse.square(), 0.0)
                tot = tot + ce.sum()
                cnt = cnt + mask.sum()
            loss = tot / torch.clamp(cnt, min=1)
        else:
            logits, aux = T.forward_train(
                model, cfg, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"),
                enc_frames=batch.get("enc_frames"))
            if cfg.n_prefix:  # vlm: loss over token region only
                logits = logits[:, cfg.n_prefix:]
            loss = cross_entropy(logits, SH.replicated(batch["labels"], logits),
                                 cfg.vocab)
        return loss + aux_coef * aux, loss, aux

    def grad_fn(params, batch):
        """(grads, loss, aux): float32 grads of the masters, in the
        params' order."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        tot, loss, aux = loss_fn(leaves, batch)
        grads = torch.autograd.grad(tot, list(leaves.values()))
        # under a mesh: reduced to the master's placement
        return ({k: SH.placed_as(g, leaves[k]) for k, g in zip(leaves, grads)},
                loss.detach(), aux.detach())

    def compute_grads(params, batch):
        if num_microbatches == 1:
            return grad_fn(params, batch)
        B = batch["tokens"].shape[0]
        if B % num_microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{num_microbatches} microbatches")
        mb = B // num_microbatches
        g = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
        p0 = next(iter(params.values()))
        l = SH.replicated(torch.zeros((), dtype=torch.float32,
                                      device=p0.device), p0)
        a = SH.replicated(torch.zeros((), dtype=torch.float32,
                                      device=p0.device), p0)
        for i in range(num_microbatches):
            sub_batch = {k: v[i * mb:(i + 1) * mb]
                         if isinstance(v, torch.Tensor) and v.ndim >= 1
                         and v.shape[0] == B else v for k, v in batch.items()}
            gi, loss, aux = grad_fn(params, sub_batch)
            g = {k: g[k] + gi[k] for k in g}
            l, a = l + loss, a + aux
        n = float(num_microbatches)
        return {k: x / n for k, x in g.items()}, l / n, a / n

    def train_step(state: TrainState, batch: dict):
        grads, loss, aux = compute_grads(state.params, batch)
        params, opt, om = adamw_update(state.params, grads, state.opt, opt_cfg)
        del grads
        # the clock tick: this step's batch event enters causal history;
        # under a mesh each rank ticks its replica (the local tensor)
        cells = state.clock_cells
        local = cells.to_local() if isinstance(cells, DTensor) else cells
        clock = bc.BloomClock(
            local, torch.zeros((), dtype=torch.int32, device=local.device),
            clock_cfg.k)
        clock = bc.tick(clock, SH.to_local(batch["ev_hi"]),
                        SH.to_local(batch["ev_lo"]))
        new_state = TrainState(params=params, opt=opt,
                               clock_cells=SH.replicated(
                                   clock.cells + clock.base, cells),
                               step=state.step + 1)
        metrics = {"loss": loss, "aux": aux, **om,
                   "clock_sum": clock.cells.sum().to(torch.float32)}
        return new_state, {k: SH.to_local(v) for k, v in metrics.items()}

    return train_step
