"""Mamba2 SSD (state-space duality) block, chunked form.

Train and prefill use the SSD block decomposition (arXiv:2405.21060):
the sequence is split into chunks of Q tokens; the intra-chunk terms are
dense (C B^T * decay mask) products, quadratic only within a chunk, and
a recurrent [B, H, P, N] state passes between the chunks.  Decode is the
O(1) recurrent update.  The JAX package computes these products outside
Pallas, so they stay ``torch.einsum``s here; the chunk recurrence is a
Python loop over the chunks (the reference's ``lax.scan``).

The reference's numerics, kept: the conv sum runs over the taps in
order from the first, the SSD runs in float32 from the compute-dtype
inputs, the gated norm is an RMS norm in float32 with eps 1e-6, and
``softplus`` is ``jax.nn.softplus``'s ``max(x, 0) + log1p(exp(-|x|))``.

One departure: the intra-chunk decay ``L[i, j] = exp(cum_i - cum_j)``
for ``j <= i``, 0 above the diagonal.  The reference takes ``exp`` of
every entry and then selects 0 above the diagonal; there the exponent
is a positive sum of up to Q - 1 terms ``dt |A|``, so at Q = 128 it
overflows to ``inf`` and the backward multiplies a zero cotangent by
``inf`` (NaN).  This module fills the exponent with ``-inf`` above the
diagonal before ``exp``: the forward's values are the same bit for bit,
and the backward is the true derivative of the same function, finite
where the reference's is NaN.

On a model mesh whose model axis has more than one rank, train and
prefill run ``ssm_heads``: each rank its SSM heads' columns of in_proj,
their channels of the conv, the SSD over them and its rows of
out_proj, the gated norm's mean of squares summed over the axis.

The decode cache is written in place, as ``attention.KVCache`` is: a
decode step stores the new conv tail and state into the cache's buffers
(a layer's view of a stacked cache) and returns an ``SSMCache`` over
the same buffers.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import sharding as SH
from repro_torch.models.config import ModelConfig

__all__ = ["ssm_block", "SSMCache", "init_ssm_cache"]


@dataclasses.dataclass
class SSMCache:
    """conv: [..., B, conv_w - 1, conv_ch] the trailing pre-conv inputs,
    in the compute dtype; state: [..., B, H, P, N] the recurrent state in
    float32; a stacked cache has a leading layer axis."""

    conv: torch.Tensor
    state: torch.Tensor

    def layer(self, i: int) -> "SSMCache":
        """Layer ``i`` of a stacked cache: views of its buffers."""
        return SSMCache(self.conv[i], self.state[i])


def init_ssm_cache(cfg: ModelConfig, batch: int, *, layers: int | None = None,
                   device=None) -> SSMCache:
    lead = () if layers is None else (layers,)
    conv_ch = cfg.d_inner_ssm + 2 * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_ch),
                         dtype=cfg.compute_dtype, device=device),
        state=torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state),
                          dtype=torch.float32, device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(params, cfg: ModelConfig, x):
    """in_proj -> (z [B,S,di], xBC [B,S,di+2N], dt_raw [B,S,H])."""
    di, N, H = cfg.d_inner_ssm, cfg.ssm_state, cfg.ssm_heads
    proj = x @ params["in_proj"].to(cfg.compute_dtype)
    return proj.split([di, di + 2 * N, H], dim=-1)


def _causal_conv(params, cfg: ModelConfig, xBC, conv_state=None):
    """Depthwise causal conv (width cfg.ssm_conv) + silu.

    Train: conv_state None, left-pad zeros.  Decode: conv_state
    [B, w-1, ch] holds the trailing context.  Returns (y, the new conv
    tail: the last w - 1 rows of the padded input)."""
    dt = cfg.compute_dtype
    w = params["conv_w"].to(dt)      # [w, ch]
    b = params["conv_b"].to(dt)
    width = w.shape[0]
    S = xBC.shape[1]
    if conv_state is None:
        full = SH.pad(xBC, (0, 0, width - 1, 0))
    else:
        full = torch.cat([conv_state, xBC], dim=1)
    new_state = full[:, -(width - 1):] if width > 1 else None
    # y[t] = sum_i w[i] * full[t + i], summed from i = 0 up
    y = w[0] * full[:, :S]
    for i in range(1, width):
        y = y + w[i] * full[:, i:i + S]
    return F.silu(y + b), new_state


def _gated_norm(params, cfg: ModelConfig, y, z, group=None):
    """Mamba2 output: RMSNorm(y * silu(z)) with learned scale.  With
    ``group``, ``y`` and ``z`` hold this rank's heads' channels (and
    ``params["norm"]`` their scales): the mean of squares over all
    ``cfg.d_inner_ssm`` channels sums the ranks' sums over the group."""
    gf = (y * F.silu(z)).float()
    if group is None:
        ms = gf.square().mean(-1, keepdim=True)
    else:
        ms = SH.all_reduce_sum(gf.square().sum(-1, keepdim=True), group,
                               sum_grads=True) / cfg.d_inner_ssm
    out = gf * torch.rsqrt(ms + 1e-6)
    return (out * params["norm"].float()).to(y.dtype)


def _intra_decay(diff: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """L = exp(diff) on and below the diagonal, 0 above it, with the
    exponent masked before ``exp`` (the module docstring's departure)."""
    return torch.exp(diff.masked_fill(~causal, float("-inf")))


def _ssd_chunked(cfg: ModelConfig, xh, dtv, A, Bm, Cm, init_state=None):
    """The SSD algorithm.

    xh: [B,S,H,P] inputs; dtv: [B,S,H] positive step sizes; A: [H] (<0);
    Bm/Cm: [B,S,N] (single group, broadcast over heads).
    Returns (y [B,S,H,P] float32, final_state [B,H,P,N]).
    """
    Bb, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    if pad:
        xh = SH.pad(xh, (0, 0, 0, 0, 0, pad))
        dtv = SH.pad(dtv, (0, 0, 0, pad))
        Bm = SH.pad(Bm, (0, 0, 0, pad))
        Cm = SH.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q

    xc = SH.reshape(xh, Bb, nc, Q, H, Pd).float()
    dtc = SH.reshape(dtv, Bb, nc, Q, H).float()
    Bc = SH.reshape(Bm, Bb, nc, Q, N).float()
    Cc = SH.reshape(Cm, Bb, nc, Q, N).float()

    dA = dtc * A                                   # [B,nc,Q,H] (negative)
    cum = SH.cumsum(dA, 2)                         # within-chunk cumulative
    chunk_sum = cum[:, :, -1, :]                   # [B,nc,H]

    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for j<=i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,Qi,Qj,H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    L = _intra_decay(diff, SH.replicated(causal[None, None, :, :, None], diff))
    # scores CB[i,j] = C_i . B_j  (single group)
    CB = SH.einsum("bcin,bcjn->bcij", Cc, Bc)
    xdt = xc * dtc[..., None]                      # dt-weighted inputs
    y_intra = SH.einsum("bcijh,bcjhp->bcihp", CB[..., None] * L, xdt)

    # chunk states: sum_j exp(chunk_sum - cum_j) * xdt_j (x) B_j
    decay_out = torch.exp(chunk_sum[:, :, None, :] - cum)  # [B,nc,Q,H]
    states = SH.einsum("bcjhp,bcjn->bchpn", xdt * decay_out[..., None], Bc)

    # inter-chunk recurrence (the reference's lax.scan); under a mesh
    # the zero state is placed as the chunk states, each rank making
    # only its shard
    if init_state is not None:
        st = init_state.float()
    elif isinstance(states, DTensor):
        st = torch.zeros_like(states[:, 0])
    else:
        st = torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(chunk_sum[:, c])[:, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)         # [B,nc,H,P,N]

    # inter-chunk output: C_i . (decay_in_i * state_prev)
    decay_in = torch.exp(cum)                      # [B,nc,Q,H]
    y_inter = (SH.einsum("bcin,bchpn->bcihp", Cc, prev_states)
               * decay_in[..., None])

    y = SH.reshape(y_intra + y_inter, Bb, Sp, H, Pd)[:, :S]
    return y, st


def _conv_tail(xBC_pre, w1: int):
    """The trailing ``w1`` pre-conv rows [B, w1, ch] (left-padded with
    zeros when S < w1), copied: a view would keep the whole in_proj
    output alive."""
    S = xBC_pre.shape[1]
    conv = (xBC_pre[:, S - w1:] if S >= w1
            else SH.pad(xBC_pre, (0, 0, w1 - S, 0)))
    return conv.to(xBC_pre.dtype, copy=True)


def ssm_heads(params: dict, cfg: ModelConfig, x: torch.Tensor,
              keep_cache: bool = True):
    """``ssm_block`` without a cache on a model mesh whose model axis has
    more than one rank (``sharding.model_split``): a ``local_map`` that
    keeps the SSM heads on their shards.  The model axis's rank r
    takes the heads ``sharding.head_range(H, model, r)`` (torch.chunk's
    split: where H does not divide the axis the last ranks hold fewer or
    none) and projects only their columns of in_proj (z, x and dt of its
    heads, the shared B and C: the weight's columns are split, not its
    output), convolves their channels, runs the SSD over them and the
    gated norm (the mean of squares over all heads: one all-reduce of
    [B, S, 1] over the model axis), and multiplies its heads' rows of
    out_proj: the output [B, S, D] is ``Partial`` over the model axis.
    With ``keep_cache`` it also returns the ``SSMCache`` placed as the
    cache's rule axes place it: the state's heads on their shards
    where H divides the axis, else gathered (one all-to-all of the
    heads' states); the conv tail's channel shard (or the whole tail)
    projected from the last w - 1 rows."""
    mesh = x.device_mesh
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di, w1 = cfg.d_inner_ssm, cfg.ssm_conv - 1
    ch = di + 2 * N
    mi, M, r = SH.model_axis(mesh)
    group = mesh.get_group("model")
    h0, h1 = SH.head_range(H, M, r)
    nh = h1 - h0
    whole = H % M == 0
    bat = SH.dp_axes(mesh, B)

    def pl(*spec):
        return SH.placements(mesh, SH.P(*spec))

    names = ["in_proj", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip",
             "norm", "out_proj"]
    w_pl = {n: pl(*([None] * params[n].ndim)) for n in names}
    w_pl["out_proj"] = pl("model" if whole else None, None)
    state_pl = SH.logical_placements(("act_batch", "act_ssm_heads", None,
                                      None), (B, H, Pd, N))
    conv_pl = SH.logical_placements(("act_batch", None, "act_mlp"),
                                    (B, w1, ch))
    state_split = state_pl[mi] == Shard(1)
    conv_split = conv_pl[mi] == Shard(2)
    x_pl = pl(bat, None, None)
    out_pls = [tuple(Partial() if i == mi else p for i, p in enumerate(x_pl))]
    if keep_cache:
        out_pls += [pl(bat, None, "model" if conv_split else None),
                    pl(bat, "model" if state_split else None, None, None)]
    own = [SH.head_range(H, M, s)[1] - SH.head_range(H, M, s)[0]
           for s in range(M)]
    # this rank's channels of xBC (its heads' x, then B and C) and of
    # in_proj (its heads' z, xBC and dt)
    x_ch = [(h0 * Pd, h1 * Pd), (di, ch)]
    in_cols = [(h0 * Pd, h1 * Pd)] + [(di + a, di + b) for a, b in x_ch] \
        + [(di + ch + h0, di + ch + h1)]

    def take(w, spans, dim=-1):
        return torch.cat([w.narrow(dim, a, b - a) for a, b in spans], dim)

    def local(x_l, *ws):
        w = dict(zip(names, ws))
        Bl = x_l.shape[0]
        proj = x_l @ take(w["in_proj"], in_cols)
        z, xBC, dt_raw = proj.split([nh * Pd, nh * Pd + 2 * N, nh], dim=-1)
        dtv = _softplus(dt_raw.float() + w["dt_bias"][h0:h1].float())
        A_ = -torch.exp(w["a_log"][h0:h1].float())
        d_skip = w["d_skip"][h0:h1].float()
        conv = {"conv_w": take(w["conv_w"], x_ch),
                "conv_b": take(w["conv_b"], x_ch)}
        xBC_c, _ = _causal_conv(conv, cfg, xBC)
        xs, Bm, Cm = xBC_c.split([nh * Pd, N, N], dim=-1)
        xh = xs.reshape(Bl, S, nh, Pd)
        y, final = _ssd_chunked(cfg, xh, dtv, A_, Bm, Cm)
        y = y + d_skip[None, None, :, None] * xh.float()
        y = y.reshape(Bl, S, nh * Pd).to(dt)
        norm = {"norm": take(w["norm"], x_ch[:1])}
        wo = w["out_proj"] if whole else take(w["out_proj"], x_ch[:1], 0)
        out = _gated_norm(norm, cfg, y, z, group) @ wo
        if not keep_cache:
            return out
        # the conv tail's channels as the cache places them, projected
        # from the last w - 1 rows
        c0, c1 = (r * ch // M, (r + 1) * ch // M) if conv_split else (0, ch)
        rows = x_l[:, max(0, S - w1):]
        tail = _conv_tail(rows @ w["in_proj"][:, di + c0:di + c1], w1)
        if not state_split:
            final = SH.exchange(final, own, 1, None, group)
        return out, tail, final

    res = local_map(local, out_placements=tuple(out_pls) if keep_cache
                    else list(out_pls[0]),
                    in_placements=(x_pl, *[w_pl[n] for n in names]),
                    in_grad_placements=(SH.summed_grads(mesh, x_pl), *[
                        SH.summed_grads(mesh, w_pl[n]) for n in names]),
                    device_mesh=mesh, redistribute_inputs=True)(
        x, *[SH.replicated(params[n], x) for n in names])
    if not keep_cache:
        return res, None
    return res[0], SSMCache(conv=res[1], state=res[2])


def ssm_block(params: dict, cfg: ModelConfig, x: torch.Tensor,
              cache: SSMCache | None = None, keep_cache: bool = True):
    """Full Mamba2 block: in_proj, conv, SSD, gated norm, out_proj.

    Returns (out [B,S,D], cache): without ``cache`` (train, prefill) a
    new ``SSMCache`` ready for decode (conv tail = the trailing pre-conv
    inputs, left-padded with zeros when S < w - 1; the final state;
    None without ``keep_cache``); with it (decode, S == 1) the same
    cache, updated in place.  On the model mesh train and prefill run
    ``ssm_heads``.
    """
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner_ssm
    w1 = cfg.ssm_conv - 1
    if cache is None and SH.model_split(x):
        return ssm_heads(params, cfg, x, keep_cache)

    z, xBC, dt_raw = _split_proj(params, cfg, x)
    dtv = _softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["a_log"].float())
    d_skip = params["d_skip"].float()

    if cache is None:
        xBC_pre = xBC
        xBC, _ = _causal_conv(params, cfg, xBC)
        xs, Bm, Cm = xBC.split([di, N, N], dim=-1)
        xh = SH.reshape(xs, B, S, H, Pd)
        y, final = _ssd_chunked(cfg, xh, dtv, A, Bm, Cm)
        y = y + d_skip[None, None, :, None] * xh.float()
        y = SH.reshape(y, B, S, di).to(dt)
        out = _gated_norm(params, cfg, y, z) @ params["out_proj"].to(dt)
        if not keep_cache:
            return out, None
        return out, SSMCache(conv=_conv_tail(xBC_pre, w1), state=final)

    # ---- decode: O(1) recurrent update (S == 1) ----
    xBC_c, new_conv = _causal_conv(params, cfg, xBC, cache.conv)
    xs, Bm, Cm = xBC_c.split([di, N, N], dim=-1)
    xh = SH.reshape(xs, B, H, Pd).float()                             # [B,H,P]
    dt1 = dtv[:, 0]                                               # [B,H]
    Bm1 = Bm[:, 0].float()                                        # [B,N]
    Cm1 = Cm[:, 0].float()
    dA = torch.exp(dt1 * A)                                       # [B,H]
    upd = (dt1[:, :, None] * xh)[..., None] * Bm1[:, None, None, :]
    state = cache.state * dA[:, :, None, None] + upd
    y = SH.einsum("bn,bhpn->bhp", Cm1, state)
    y = y + d_skip[None, :, None] * xh
    y = SH.reshape(y, B, 1, di).to(dt)
    out = _gated_norm(params, cfg, y, z) @ params["out_proj"].to(dt)
    conv = SH.assign(cache.conv, ..., new_conv)
    return out, SSMCache(conv=conv, state=SH.assign(cache.state, ..., state))
