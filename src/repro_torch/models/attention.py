"""Attention: GQA with chunked online softmax.

Train and prefill attention stream the KV sequence in chunks with the
online-softmax recurrence (running max and normalizer), the
flash-attention decomposition written as tensor code, exactly as the
JAX package writes it at the XLA level: the same chunk boundaries, the
same ``NEG_INF`` fill and ``1e-30`` floor, scores and the accumulator
in float32 (``acc_dtype`` bfloat16 when ``cfg.attn_acc == "bf16"``).
The model code has no Pallas kernel, so none is ported here.

Masks: causal, sliding window (0 = off), non-causal (the encoder, and
cross-attention: ``attn_block``'s ``xa``, K and V from the encoder's
output, no RoPE, never a self-attention cache).  Decode (Sq == 1)
runs the same path single-shot against a cache; sliding-window decode
keeps a ring buffer (softmax is permutation-invariant over KV, and RoPE
is applied before keys are cached, so ring order needs no rotation).
The enc-dec decoder's cross K/V live in a ``CrossCache``, which decode
reads and never writes.

The cache is written in place: ``cache_update`` stores the new token's
K/V into the cache's buffers and returns a ``KVCache`` over the same
buffers with ``length`` and ``pos`` advanced (the JAX package returns
new arrays).  ``length`` and ``pos`` are host integers, so a decode step
reads nothing back from the card.

Under the model mesh (``sharding.use_mesh_rules``) the block runs on
DTensors: the tensors made inside it (positions' masks, the running max
and sum) follow the mesh replicated, and the cache write, which has no
DTensor strategy into a sharded slice, runs on replicated operands
(``sharding.assign``), as GSPMD writes it.  The explicit-collective
paths, split-KV decode (``decode_attention_split_kv``) and the
owner-writes slot update (``_sharded_slot_update``), are still to be
ported (``local_map`` with functional collectives); with
``decode_attn="split_kv"`` decode takes the reference's path without
them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rope

__all__ = ["attention_core", "attn_block", "KVCache", "CrossCache",
           "init_cache", "cache_update"]

NEG_INF = -1e30


def attention_core(
    q: torch.Tensor,          # [B, Sq, H, Dh]
    k: torch.Tensor,          # [B, Skv, KV, Dh]
    v: torch.Tensor,          # [B, Skv, KV, Dv]
    *,
    causal: bool,
    window: int,              # 0 = full
    q_offset,                 # absolute position of q[0] (int or 0-d)
    kv_valid: int,            # number of valid kv positions
    chunk: int,
    acc_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    dev = q.device
    qg = SH.reshape(q, B, Sq, KV, G, Dh).to(acc_dtype).float()
    # 1/sqrt(Dh) rounded to acc_dtype, as the reference rounds it
    scale = float(torch.tensor(1.0 / (Dh ** 0.5), dtype=acc_dtype))

    if Sq == 1:
        chunk = Skv           # decode: one shot over the whole buffer
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    if pad:                   # the padded tail is masked off by kv_valid
        k = SH.pad(k, (0, 0, 0, 0, 0, pad))
        v = SH.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid = min(kv_valid, Skv)
    n_chunks = (Skv + pad) // chunk

    q_pos = q_offset + torch.arange(Sq, device=dev)
    # the running stats follow q's mesh (replicated) under a mesh
    acc = SH.replicated(
        torch.zeros((B, Sq, KV, G, Dv), dtype=acc_dtype, device=dev), q)
    m_run = SH.replicated(torch.full((B, Sq, KV, G), NEG_INF,
                                     dtype=torch.float32, device=dev), q)
    l_run = SH.replicated(
        torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev), q)
    for c in range(n_chunks):
        start = c * chunk
        kc = k[:, start:start + chunk].to(acc_dtype)
        vc = v[:, start:start + chunk].to(acc_dtype)
        kv_pos = start + torch.arange(chunk, device=dev)
        s = SH.einsum("bqkgd,bckd->bqkgc", qg, kc.float()) * scale
        mask = (kv_pos < kv_valid)[None, :]
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(SH.replicated(mask[None, :, None, None, :], s), s,
                        NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr.to(acc_dtype)[..., None] + SH.einsum(
            "bqkgc,bckd->bqkgd", p.to(acc_dtype), vc)
        m_run = m_new
    out = acc.float() / torch.clamp(l_run, min=1e-30)[..., None]
    return SH.reshape(out, B, Sq, H, Dv).to(q.dtype)


@dataclasses.dataclass
class KVCache:
    """Decode cache. k/v: [..., B, S_buf, KV, Dh] (ring buffer when
    windowed); a stacked cache has a leading layer axis.

    length: valid entries; pos: absolute position of the next token
    (host integers, the same for every layer of a stack).
    """

    k: torch.Tensor
    v: torch.Tensor
    length: int
    pos: int
    ring: bool = False

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache: views of its buffers."""
        return KVCache(self.k[i], self.v[i], self.length, self.pos,
                       self.ring)


@dataclasses.dataclass
class CrossCache:
    """An enc-dec decoder's cross K/V, [..., B, enc_seq, KV, Dh] each
    (the reference's ``(ck, cv)`` pair); a stacked cache has a leading
    layer axis.  Prefill fills it, decode only reads it."""

    k: torch.Tensor
    v: torch.Tensor

    def layer(self, i: int) -> "CrossCache":
        """Layer ``i`` of a stacked cache: views of its buffers."""
        return CrossCache(self.k[i], self.v[i])


def init_cache(cfg: ModelConfig, batch: int, buf_len: int, kv_heads: int,
               d_head: int, ring: bool = False, *, layers: int | None = None,
               device=None) -> KVCache:
    lead = () if layers is None else (layers,)
    shape = lead + (batch, buf_len, kv_heads, d_head)
    dt = cfg.compute_dtype
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   length=0, pos=0, ring=ring)


def cache_update(cache: KVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> KVCache:
    """Append one step (Sq=1) at the ring/linear write position, in
    place (see the module docstring)."""
    buf = cache.k.shape[-3]
    slot = cache.pos % buf if cache.ring else min(cache.pos, buf - 1)
    key = (..., slice(slot, slot + 1), slice(None), slice(None))
    return KVCache(k=SH.assign(cache.k, key, k_new),
                   v=SH.assign(cache.v, key, v_new),
                   length=min(cache.length + 1, buf), pos=cache.pos + 1,
                   ring=cache.ring)


def attn_block(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,              # [B, Sq, D]
    *,
    positions: torch.Tensor,      # [Sq] absolute
    causal: bool = True,
    window: int = 0,
    cache: KVCache | None = None,
    angles=None,                  # layers.rope_angles of ``positions``
    xa: torch.Tensor | None = None,   # cross-attention source [B, Se, D]
):
    """Full GQA block: qkv proj, rope, core, out proj.

    Returns (out [B,Sq,D], new_cache): in prefill (and with ``xa``) the
    new (k, v), in decode the updated cache.
    """
    dt = cfg.compute_dtype
    B, Sq, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    q = x @ params["wq"].to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
    q = SH.reshape(q, B, Sq, H, Dh)
    kv_src = xa if xa is not None else x
    Skv = kv_src.shape[1]
    k = kv_src @ params["wk"].to(dt)
    v = kv_src @ params["wv"].to(dt)
    if "bk" in params:
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    k = SH.reshape(k, B, Skv, KV, Dh)
    v = SH.reshape(v, B, Skv, KV, Dh)

    if cfg.pos == "rope" and xa is None:
        q = rope(q, positions, cfg, angles=angles)
        k = rope(k, positions, cfg, angles=angles)

    acc = torch.bfloat16 if cfg.attn_acc == "bf16" else torch.float32
    if cache is not None and xa is None:
        new_cache = cache_update(cache, k, v)
        # linear cache: slot == absolute position, so the window mask
        # applies; ring cache: the buffer is the window, and positions
        # in it are not absolute, so the mask stays off
        out = attention_core(
            q, new_cache.k, new_cache.v, causal=False,
            window=0 if cache.ring else window, q_offset=new_cache.pos - 1,
            kv_valid=new_cache.length, chunk=cfg.attn_chunk, acc_dtype=acc)
    else:
        new_cache = (k, v)   # prefill: the stack builds the cache from it
        out = attention_core(
            q, k, v, causal=causal and xa is None, window=window,
            q_offset=positions[0] if causal else 0, kv_valid=Skv,
            chunk=cfg.attn_chunk, acc_dtype=acc)
    out = SH.reshape(out, B, Sq, H * Dh) @ params["wo"].to(dt)
    return out, new_cache
