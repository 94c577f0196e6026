"""Multi-head Latent Attention (DeepSeek-V2) with absorbed-matmul decode.

Train/prefill: decompress c_kv -> per-head K_nope/V and run standard
attention (kv heads == q heads) through ``attention.attention_core``,
whose value width may differ from the key width.  Decode: the cache
holds only the compressed latent (kv_lora + the shared rope key = 576
values a token for the 236B config), and W_uk / W_uv are *absorbed* into
the query and output projections, so scores are taken directly against
the latent in float32, as the JAX package takes them.

The cache is written in place, as ``attention.KVCache`` is: the decode
step stores the new token's latent and rope key into the cache's
buffers and returns an ``MLACache`` over the same buffers with
``length`` and ``pos`` (host integers) advanced.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import sharding as SH
from repro_torch.models.attention import NEG_INF, attention_core
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rope

__all__ = ["mla_block", "MLACache", "init_mla_cache"]


@dataclasses.dataclass
class MLACache:
    """ckv: [..., B, S_buf, kv_lora]; krope: [..., B, S_buf, qk_rope_dim]
    (rope applied); a stacked cache has a leading layer axis.

    length: valid entries; pos: absolute position of the next token
    (host integers, the same for every layer of a stack).
    """

    ckv: torch.Tensor
    krope: torch.Tensor
    length: int
    pos: int

    def layer(self, i: int) -> "MLACache":
        """Layer ``i`` of a stacked cache: views of its buffers."""
        return MLACache(self.ckv[i], self.krope[i], self.length, self.pos)


def init_mla_cache(cfg: ModelConfig, batch: int, buf_len: int, *,
                   layers: int | None = None, device=None) -> MLACache:
    lead = () if layers is None else (layers,)
    dt = cfg.compute_dtype
    return MLACache(
        ckv=torch.zeros(lead + (batch, buf_len, cfg.kv_lora_rank), dtype=dt,
                        device=device),
        krope=torch.zeros(lead + (batch, buf_len, cfg.qk_rope_dim), dtype=dt,
                          device=device),
        length=0, pos=0)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def _project_q(params, cfg: ModelConfig, x, positions, angles=None):
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    cq = _rms(x @ params["w_dq"].to(dt), params["q_norm"])
    q = SH.reshape(cq @ params["w_uq"].to(dt),
                   B, S, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_rope = rope(q_rope, positions, cfg, dim=cfg.qk_rope_dim, angles=angles)
    return q_nope, q_rope


def _project_kv_latent(params, cfg: ModelConfig, x, positions, angles=None):
    dt = cfg.compute_dtype
    dkv = x @ params["w_dkv"].to(dt)
    ckv, k_rope = dkv.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    ckv = _rms(ckv, params["kv_norm"])
    # the shared (single-head) rope key
    k_rope = rope(k_rope[:, :, None, :], positions, cfg, dim=cfg.qk_rope_dim,
                  angles=angles)[:, :, 0, :]
    return ckv, k_rope


def mla_block(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,              # [B, S, D]
    *,
    positions: torch.Tensor,      # [S] absolute
    cache: MLACache | None = None,
    angles=None,                  # layers.rope_angles at qk_rope_dim
):
    """Returns (out, new_cache_or_latents): in train/prefill the
    (ckv, k_rope) latents, in decode the updated cache."""
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    H, L = cfg.n_heads, cfg.kv_lora_rank

    q_nope, q_rope = _project_q(params, cfg, x, positions, angles)
    ckv, k_rope = _project_kv_latent(params, cfg, x, positions, angles)
    w_uk = SH.reshape(params["w_uk"].to(dt), L, H, cfg.qk_nope_dim)
    w_uv = SH.reshape(params["w_uv"].to(dt), L, H, cfg.v_head_dim)

    if cache is None:
        # ---- train/prefill: decompress and run standard attention ----
        k_nope = SH.einsum("bsl,lhd->bshd", ckv, w_uk)
        v = SH.einsum("bsl,lhd->bshd", ckv, w_uv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, cfg.qk_rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = attention_core(q, k, v, causal=True, window=0,
                             q_offset=positions[0], kv_valid=S,
                             chunk=cfg.attn_chunk)
        out = SH.reshape(out, B, S, H * cfg.v_head_dim) @ params["wo"].to(dt)
        return out, (ckv, k_rope)

    # ---- decode: absorbed matmuls against the latent cache ----
    buf = cache.ckv.shape[-2]
    slot = min(cache.pos, buf - 1)
    key = (..., slice(slot, slot + 1), slice(None))
    new_cache = MLACache(ckv=SH.assign(cache.ckv, key, ckv),
                         krope=SH.assign(cache.krope, key, k_rope),
                         length=min(cache.length + 1, buf), pos=cache.pos + 1)
    # absorb W_uk into q: q_lat [B, 1, H, kv_lora]
    q_lat = SH.einsum("bshd,lhd->bshl", q_nope, w_uk)
    # 1 / sqrt(qk) in float32, as the reference computes it
    scale = float(np.float32(1.0) / np.sqrt(np.float32(
        cfg.qk_nope_dim + cfg.qk_rope_dim)))
    ckv_f = new_cache.ckv.float()
    s_lat = SH.einsum("bshl,bTl->bshT", q_lat.float(), ckv_f)
    s_rope = SH.einsum("bshd,bTd->bshT", q_rope.float(),
                          new_cache.krope.float())
    s = (s_lat + s_rope) * scale
    valid = torch.arange(buf, device=x.device) < new_cache.length
    s = torch.where(SH.replicated(valid[None, None, None, :], s), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # attend over latents, then decompress once per head (absorbed W_uv)
    ctx_lat = SH.einsum("bshT,bTl->bshl", p, ckv_f)
    ctx = SH.einsum("bshl,lhd->bshd", ctx_lat.to(dt), w_uv)
    out = SH.reshape(ctx, B, S, H * cfg.v_head_dim) @ params["wo"].to(dt)
    return out, new_cache
