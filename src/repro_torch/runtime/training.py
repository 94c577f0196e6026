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
"""
from __future__ import annotations

import dataclasses

import torch

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
    return torch.gather(logits, -1, idx[..., None])[..., 0]


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
            labels = batch["labels"]
            if pad:
                hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
                labels = torch.nn.functional.pad(labels, (0, pad),
                                                 value=-1)  # masked out
            tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
            cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
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
            loss = cross_entropy(logits, batch["labels"], cfg.vocab)
        return loss + aux_coef * aux, loss, aux

    def grad_fn(params, batch):
        """(grads, loss, aux): float32 grads of the masters, in the
        params' order."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        tot, loss, aux = loss_fn(leaves, batch)
        grads = torch.autograd.grad(tot, list(leaves.values()))
        return dict(zip(leaves, grads)), loss.detach(), aux.detach()

    def compute_grads(params, batch):
        if num_microbatches == 1:
            return grad_fn(params, batch)
        B = batch["tokens"].shape[0]
        if B % num_microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{num_microbatches} microbatches")
        mb = B // num_microbatches
        g = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
        dev = next(iter(params.values())).device
        l = torch.zeros((), dtype=torch.float32, device=dev)
        a = torch.zeros((), dtype=torch.float32, device=dev)
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
        # the clock tick: this step's batch event enters causal history
        clock = bc.BloomClock(
            state.clock_cells,
            torch.zeros((), dtype=torch.int32, device=state.clock_cells.device),
            clock_cfg.k)
        clock = bc.tick(clock, batch["ev_hi"], batch["ev_lo"])
        new_state = TrainState(params=params, opt=opt,
                               clock_cells=clock.cells + clock.base,
                               step=state.step + 1)
        metrics = {"loss": loss, "aux": aux, **om,
                   "clock_sum": clock.cells.sum().to(torch.float32)}
        return new_state, metrics

    return train_step
