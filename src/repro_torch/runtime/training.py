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
The loss keeps the logits on their vocab shards: ``vocab_parallel_ce``
is a ``local_map`` whose per-position log-sum-exp and gold logit are
combined across the vocab shards by three small all-reduces, and whose
backward is local to each shard (``_VocabParallelCE``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import sharding as SH
from repro_torch.core import clock as bc
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state
from repro_torch.runtime.clock_runtime import ClockConfig

__all__ = ["TrainState", "init_train_state", "make_train_step", "cross_entropy",
           "chunked_cross_entropy", "vocab_parallel_ce"]


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


#: positions a chunk of ``_VocabParallelCE``'s backward, at most this
#: many float32 bytes of logits a chunk (the whole shard is never cast)
_CE_CHUNK_BYTES = 64 << 20


def _position_blocks(B: int, S: int, rows: int):
    """Index pairs covering a [B, S] grid in blocks of at most ``rows``
    positions (whole batch rows where a row fits)."""
    if rows >= S:
        step = rows // S
        return [(slice(b, min(B, b + step)), slice(None))
                for b in range(0, B, step)]
    return [(slice(b, b + 1), slice(s, min(S, s + rows)))
            for b in range(B) for s in range(0, S, rows)]


class _VocabParallelCE(torch.autograd.Function):
    """(lse, gold) of one rank's vocab shard ``x`` [B, S, V_loc] (any
    float dtype), the shard starting at vocab ``offset``, combined over
    the process ``groups`` that split the vocab (none: the whole vocab
    is local).

    Forward: the shard's float32 copy gives the gold logit of the labels
    in [offset, offset + V_loc) (0 elsewhere) and then, in place,
    ``torch.logsumexp``'s own steps (max, subtract, exp, sum, log, add:
    on a whole vocab it is bit-identical to ``torch.logsumexp``); across
    a group, m = max of the shards' lse, lse = m + log(sum exp(lse_shard
    - m)), gold = sum of the shards' golds.  Backward, with no
    collective: exp(x - lse) g_lse, plus g_gold at each owned label,
    computed a block of positions at a time and cast to ``x``'s dtype,
    the same float32 steps as autograd's through ``logsumexp`` and
    ``gather``."""

    @staticmethod
    def forward(ctx, x, labels, offset: int, groups: tuple):
        lf = x.to(torch.float32, copy=True)
        V = lf.shape[-1]
        lab = labels.long()
        own = (lab >= offset) & (lab < offset + V)
        idx = (lab - offset).clamp(0, V - 1)[..., None]
        gold = torch.where(own, torch.gather(lf, -1, idx)[..., 0], 0.0)
        m = lf.amax(-1, keepdim=True)
        m.masked_fill_(m.abs() == float("inf"), 0)
        lse = lf.sub_(m).exp_().sum(-1).log_().add_(m[..., 0])
        del lf
        for group in groups:
            top = fc.wait_tensor(fc.all_reduce(lse, "max", group))
            top = top.masked_fill(top.isinf(), 0)
            lse = top + torch.log(fc.wait_tensor(
                fc.all_reduce(torch.exp(lse - top), "sum", group)))
            gold = fc.wait_tensor(fc.all_reduce(gold, "sum", group))
        ctx.save_for_backward(x, lse, idx, own)
        return lse, gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        x, lse, idx, own = ctx.saved_tensors
        B, S, V = x.shape
        g_gold = torch.where(own, g_gold, 0.0)
        out = torch.empty((B, S, V), dtype=x.dtype, device=x.device)
        for blk in _position_blocks(B, S, max(1, _CE_CHUNK_BYTES // (4 * V))):
            t = x[blk].to(torch.float32, copy=True)
            t.sub_(lse[blk][..., None]).exp_().mul_(g_lse[blk][..., None])
            t.scatter_add_(-1, idx[blk], g_gold[blk][..., None])
            out[blk] = t
        return out, None, None, None


def vocab_parallel_ce(logits: DTensor, labels: torch.Tensor):
    """(lse, gold) [B, S] of DTensor logits [B, S, V] and labels [B, S]
    (plain or DTensor), a ``local_map`` over the logits' mesh.  The
    logits are placed by the mesh rules' ("act_batch", "act_seq",
    "act_vocab") first; their vocab dim stays on the mesh dims that
    shard it evenly (``_VocabParallelCE`` combines it there with three
    all-reduces of [B_loc, S_loc] float32), their batch and seq dims on
    those that shard them, and the labels and both outputs are placed
    as the batch and seq dims.  Where the vocab does not divide its
    axis the rules replicate it, and each rank takes the plain formula
    over its positions.  Labels outside [0, V) have gold 0 (the caller
    masks them)."""
    logits = SH.shard(logits, ("act_batch", "act_seq", "act_vocab"))
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    split: dict = {}                       # tensor dim -> ranks over it
    pl = []
    for p, n in zip(logits.placements, mesh.shape):
        d = p.dim if type(p) is Shard else None
        if d is not None and logits.shape[d] % (split.get(d, 1) * n) == 0:
            split[d] = split.get(d, 1) * n
            pl.append(p)
        else:
            pl.append(Replicate())
    vocab_dims = [i for i, p in enumerate(pl) if p == Shard(vdim)]
    pos_pl = tuple(Replicate() if i in vocab_dims else p
                   for i, p in enumerate(pl))
    groups = tuple(mesh.get_group(i) for i in vocab_dims)

    def local(x, lab):
        shard = 0
        for i in vocab_dims:
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
        return _VocabParallelCE.apply(x, lab, shard * x.shape[-1], groups)

    return local_map(local, out_placements=(pos_pl, pos_pl),
                     in_placements=(tuple(pl), pos_pl), device_mesh=mesh,
                     redistribute_inputs=True)(
        logits, SH.replicated(labels, logits))


def _lse_gold(logits: torch.Tensor, labels: torch.Tensor):
    """(lse, gold) in float32 per position: ``vocab_parallel_ce`` on a
    DTensor, ``torch.logsumexp`` and ``_gold`` on a plain tensor."""
    if isinstance(logits, DTensor):
        return vocab_parallel_ce(logits, labels)
    lf = logits.to(torch.float32)
    return torch.logsumexp(lf, dim=-1), _gold(lf, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Stable CE in fp32 with optional z-loss; ignores labels < 0 and
    labels >= vocab.  DTensor logits keep their vocab shards
    (``vocab_parallel_ce``)."""
    labels = SH.replicated(labels, logits)
    lse, gold = _lse_gold(logits, labels)
    ce = lse - gold
    mask = (labels >= 0) & (labels < vocab)
    denom = torch.clamp(mask.sum(), min=1)
    loss = torch.where(mask, ce, 0.0).sum() / denom
    if z_loss:
        loss = loss + z_loss * torch.where(mask, lse.square(), 0.0).sum() / denom
    return loss


def chunked_cross_entropy(unembed, hidden: torch.Tensor,
                          labels: torch.Tensor, vocab: int,
                          chunk: int) -> torch.Tensor:
    """The seq-chunked CE of ``cfg.ce_chunk``: never materialize the
    full [B, S, V] logits -- ``unembed`` (final-normed hidden [B, C, D]
    -> logits) and the log-sum-exp chunk by chunk (the logits of a chunk
    are freed before the next chunk is formed), z-loss 1e-4, labels < 0
    and >= vocab ignored."""
    S = hidden.shape[1]
    C = min(chunk, S)
    pad = (-S) % C
    labels = SH.replicated(labels, hidden)
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
        lse, gold = _lse_gold(unembed(h), lb)
        mask = (lb >= 0) & (lb < vocab)
        ce = torch.where(mask, lse - gold + 1e-4 * lse.square(), 0.0)
        tot = tot + ce.sum()
        cnt = cnt + mask.sum()
    return tot / torch.clamp(cnt, min=1)


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
        # differentiated function, so the casts are in the graph (under
        # the model mesh each layer's inside its remat function)
        model = T.build(params, cfg)
        if cfg.ce_chunk:
            hidden, aux = T.forward_hidden(
                model, cfg, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"),
                enc_frames=batch.get("enc_frames"))
            if cfg.n_prefix:
                hidden = hidden[:, cfg.n_prefix:]
            loss = chunked_cross_entropy(model.unembed, hidden,
                                         batch["labels"], cfg.vocab,
                                         cfg.ce_chunk)
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
