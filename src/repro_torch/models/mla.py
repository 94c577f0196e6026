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

Under the model mesh a latent cache whose seq dim the model axis shards
(``launch.specs.cache_shardings`` places it so) is written by the shard
that owns the slot (``attention._sharded_slot_update``), and the
absorbed attention runs on each shard's slice of the slots, the
softmax's stats combined over the axis (``_absorbed_on_shards``): no
decode step gathers the cache.  A cache placed otherwise is written
through ``sharding.assign`` and attended with ``sharding.einsum``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor.experimental import local_map

from repro_torch import sharding as SH
from repro_torch.models import attention as A
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
    mesh = SH.current_mesh()
    on_shards = all(A._seq_sharded(t, mesh, seq_dim=-2)
                    for t in (cache.ckv, cache.krope))
    if on_shards:
        ckv_c = A._sharded_slot_update(cache.ckv, ckv, slot, mesh, seq_dim=-2)
        krope_c = A._sharded_slot_update(cache.krope, k_rope, slot, mesh,
                                         seq_dim=-2)
    else:
        key = (..., slice(slot, slot + 1), slice(None))
        ckv_c = SH.assign(cache.ckv, key, ckv)
        krope_c = SH.assign(cache.krope, key, k_rope)
    new_cache = MLACache(ckv=ckv_c, krope=krope_c,
                         length=min(cache.length + 1, buf), pos=cache.pos + 1)
    # absorb W_uk into q: q_lat [B, 1, H, kv_lora]
    q_lat = SH.einsum("bshd,lhd->bshl", q_nope, w_uk)
    # 1 / sqrt(qk) in float32, as the reference computes it
    scale = float(np.float32(1.0) / np.sqrt(np.float32(
        cfg.qk_nope_dim + cfg.qk_rope_dim)))
    if on_shards:
        ctx_lat = _absorbed_on_shards(q_lat, q_rope, ckv_c, krope_c,
                                      length=new_cache.length, scale=scale,
                                      mesh=mesh)
    else:
        ckv_f = ckv_c.float()
        s_lat = SH.einsum("bshl,bTl->bshT", q_lat.float(), ckv_f)
        s_rope = SH.einsum("bshd,bTd->bshT", q_rope.float(), krope_c.float())
        s = (s_lat + s_rope) * scale
        valid = torch.arange(buf, device=x.device) < new_cache.length
        s = torch.where(SH.replicated(valid[None, None, None, :], s), s,
                        NEG_INF)
        p = torch.softmax(s, dim=-1)
        # attend over latents, then decompress once per head (absorbed W_uv)
        ctx_lat = SH.einsum("bshT,bTl->bshl", p, ckv_f)
    ctx = SH.einsum("bshl,lhd->bshd", ctx_lat.to(dt), w_uv)
    out = SH.reshape(ctx, B, S, H * cfg.v_head_dim) @ params["wo"].to(dt)
    return out, new_cache


def _absorbed_on_shards(q_lat, q_rope, ckv, krope, *, length: int,
                        scale: float, mesh, axis: str = "model"):
    """Decode's absorbed attention over a latent cache whose seq dim
    ``axis`` shards: each shard scores its slice of the slots in float32
    (``(s_lat + s_rope) * scale``, slots at or past ``length`` masked
    with ``NEG_INF``), and the shards combine the softmax with
    functional all-reduces over ``axis``: the max, then the sum of
    ``exp(s - max)``, then ``p = exp(s - max) / sum`` on each shard,
    then the sum of the shards' ``p . ckv`` [B, 1, H, L].  Nothing of
    the cache crosses the mesh.  The batch stays on its dp shards.  The
    queries come in on their head shards over ``axis`` (as the heads'
    projections leave them) and are made whole by one more all-reduce
    (each rank's heads, zeros at the others': the gathered queries bit
    for bit).

    q_lat [B, 1, H, L], q_rope [B, 1, H, R]; ckv [B, S_buf, L], krope
    [B, S_buf, R] with S_buf sharded over ``axis``; ``length`` a host
    integer.  A ``local_map`` over ``mesh``: returns the float32 context
    [B, 1, H, L] replicated over ``axis``.  Decode only: no backward
    (the max has none)."""
    B, Sq, H, L = q_lat.shape
    R = q_rope.shape[-1]
    M = SH.axis_sizes(mesh)[axis]
    dp = SH.dp_axes(mesh, B)
    q_pl = SH.placements(mesh, SH.P(dp, None, axis, None))
    c_pl = SH.placements(mesh, SH.P(dp, axis, None))
    out_pl = SH.placements(mesh, SH.P(dp, None, None, None))
    group = mesh.get_group(axis)

    def local(ql, qr, c, kr):
        shard = mesh.get_local_rank(axis)
        h0, h1 = SH.head_range(H, M, shard)
        q = ql.new_zeros(ql.shape[:2] + (H, L + R))
        q[:, :, h0:h1] = torch.cat([ql, qr], dim=-1)
        ql, qr = fc.wait_tensor(fc.all_reduce(q, "sum", group)).split(
            [L, R], dim=-1)
        S_loc = c.shape[1]
        kv_pos = shard * S_loc + torch.arange(S_loc, device=c.device)
        # the plain path's float32 ops, in place where they make a score
        # tensor: no more than two [B, 1, H, S_loc] live at once
        s_rope = torch.einsum("bshd,bTd->bshT", qr.float(), kr.float())
        cf = c.float()
        s = torch.einsum("bshl,bTl->bshT", ql.float(), cf).add_(s_rope)
        del s_rope
        s.mul_(scale).masked_fill_(kv_pos >= length, NEG_INF)
        m = fc.all_reduce(s.amax(-1, keepdim=True), "max", group)
        p = s.sub_(m).exp_()
        p.div_(fc.all_reduce(p.sum(-1, keepdim=True), "sum", group))
        return fc.wait_tensor(fc.all_reduce(
            torch.einsum("bshT,bTl->bshl", p, cf), "sum", group))

    return local_map(local, out_placements=list(out_pl),
                     in_placements=(q_pl, q_pl, c_pl, c_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q_lat, q_rope, ckv, krope)
