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

The decode cache is written in place, as ``attention.KVCache`` is: a
decode step stores the new conv tail and state into the cache's buffers
(a layer's view of a stacked cache) and returns an ``SSMCache`` over
the same buffers.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

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


def _gated_norm(params, cfg: ModelConfig, y, z):
    """Mamba2 output: RMSNorm(y * silu(z)) with learned scale."""
    gf = (y * F.silu(z)).float()
    out = gf * torch.rsqrt(gf.square().mean(-1, keepdim=True) + 1e-6)
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


def ssm_block(params: dict, cfg: ModelConfig, x: torch.Tensor,
              cache: SSMCache | None = None):
    """Full Mamba2 block: in_proj, conv, SSD, gated norm, out_proj.

    Returns (out [B,S,D], cache): without ``cache`` (train, prefill) a
    new ``SSMCache`` ready for decode (conv tail = the trailing pre-conv
    inputs, left-padded with zeros when S < w - 1; the final state);
    with it (decode, S == 1) the same cache, updated in place.
    """
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner_ssm
    w1 = cfg.ssm_conv - 1

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
        conv = (xBC_pre[:, S - w1:] if S >= w1
                else SH.pad(xBC_pre, (0, 0, w1 - S, 0)))
        # a copy: a view would keep the whole in_proj output alive
        return out, SSMCache(conv=conv.to(dt, copy=True), state=final)

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
