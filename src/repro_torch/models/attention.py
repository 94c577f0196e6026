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
DTensors: the positions' masks made inside it follow the mesh
replicated, the running max, sum and accumulator are built on each rank
at the local shape of the queries' shard (``_stat_like``), and the
cache write, which has no DTensor strategy into a sharded slice, runs
on replicated operands (``sharding.assign``), as GSPMD writes it.  With
``decode_attn="split_kv"`` decode takes the reference's two explicit
paths instead, each a ``local_map`` over the mesh: the owner-writes
slot update (``_sharded_slot_update``), in which only the shard that
holds the slot writes, in place and with no collective, and split-KV
decode (``decode_attention_split_kv``), in which each seq shard of the
cache computes the partial softmax stats over its slice and the shards
combine them with functional all-reduces (max, then sums) over the
model axis.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rope

__all__ = ["attention_core", "attn_block", "KVCache", "CrossCache",
           "init_cache", "cache_update", "decode_attention_split_kv"]

NEG_INF = -1e30


def _dp_axes(mesh, batch: int):
    """The mesh's dp axes ("pod", "data") that shard a batch of
    ``batch``, or None where the batch does not divide their extent (the
    batch is then replicated, as in the reference)."""
    sizes = SH.axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    if batch % max(1, math.prod(sizes[a] for a in dp)) or not dp:
        return None
    return dp


def _on_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as a DTensor: a plain tensor is taken as the same global
    value on every rank (replicated)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def decode_attention_split_kv(q, k, v, *, kv_valid: int, window: int,
                              q_pos: int, mesh, axis: str = "model"):
    """Split-KV decode attention (flash-decode): the cache stays sharded
    over ``axis`` along its seq dim; each shard computes the partial
    softmax stats (m, l, acc) over its slice, and the shards combine
    them with functional all-reduces over ``axis`` (max, then two
    sums): a [B, 1, H, Dv] accumulator crosses the mesh instead of the
    whole K and V.  The batch stays sharded over the dp axes, replicated
    where it does not divide them.

    q: [B, 1, H, Dh] (replicated over ``axis``); k/v: [B, Skv, KV, Dh]
    with Skv sharded over ``axis``; ``kv_valid``, ``window`` (0 = off)
    and ``q_pos`` host integers.  A ``local_map`` over ``mesh``: the
    operands are redistributed to those placements, and the output comes
    out placed as q.  Decode only: no backward (the max has none).
    """
    B, Sq, H, Dh = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    G = H // KV
    dp = _dp_axes(mesh, B)
    q_pl = SH.placements(mesh, SH.P(dp, None, None, None))
    kv_pl = SH.placements(mesh, SH.P(dp, axis, None, None))
    group = mesh.get_group(axis)

    def local(q_l, k_l, v_l):
        B_loc, S_loc = q_l.shape[0], k_l.shape[1]
        shard = mesh.get_local_rank(axis)
        kv_pos = shard * S_loc + torch.arange(S_loc, device=q_l.device)
        qg = q_l.reshape(B_loc, Sq, KV, G, Dh).float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, k_l.float()) / (Dh ** 0.5)
        mask = kv_pos < kv_valid
        if window:
            mask = mask & (kv_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_loc = s.amax(-1)
        p = torch.exp(s - m_loc[..., None])
        l_loc = p.sum(-1)
        acc_loc = torch.einsum("bqkgc,bckd->bqkgd", p, v_l.float())
        # combine the partial stats across the seq shards
        m = fc.all_reduce(m_loc, "max", group)
        corr = torch.exp(m_loc - m)
        l = fc.all_reduce(l_loc * corr, "sum", group)
        acc = fc.all_reduce(acc_loc * corr[..., None], "sum", group)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.reshape(B_loc, Sq, H, Dv).to(q_l.dtype)

    plain = not any(isinstance(t, DTensor) for t in (q, k, v))
    out = local_map(local, out_placements=list(q_pl),
                    in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh,
                    redistribute_inputs=True)(
        *(_on_mesh(t, mesh) for t in (q, k, v)))
    return out.full_tensor() if plain else out


def _stat_like(qg: DTensor, last: tuple, fill: float,
               dtype: torch.dtype) -> DTensor:
    """A running stat of the grouped queries ``qg`` [B, Sq, KV, G, Dh]:
    ``fill`` over qg's leading dims + ``last``, placed as qg on those
    dims (replicated where qg shards its last), each rank making only
    its local shard, so no rank holds the global shape."""
    lead = qg.ndim - 1
    pl = tuple(p if isinstance(p, Shard) and p.dim < lead else Replicate()
               for p in qg.placements)
    loc = qg.to_local()
    shape = torch.Size(tuple(qg.shape[:lead]) + last)
    local = torch.full(tuple(loc.shape[:lead]) + last, fill, dtype=dtype,
                       device=loc.device)
    return DTensor.from_local(local, qg.device_mesh, pl, run_check=False,
                              shape=shape, stride=SH._dense_stride(shape))


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
    if isinstance(qg, DTensor):   # each rank builds its shard of qg's dims
        acc = _stat_like(qg, (Dv,), 0.0, acc_dtype)
        m_run = _stat_like(qg, (), NEG_INF, torch.float32)
        l_run = _stat_like(qg, (), 0.0, torch.float32)
    else:
        acc = torch.zeros((B, Sq, KV, G, Dv), dtype=acc_dtype, device=dev)
        m_run = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
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


def _sharded_slot_update(buf: torch.Tensor, new_row: torch.Tensor,
                         slot: int, mesh, axis: str = "model") -> torch.Tensor:
    """Owner-writes update of a seq-sharded buffer [..., B, S_buf, ...]
    (seq at dim -3, the batch before it): the rows of ``new_row`` go to
    slots ``slot ..`` of the one shard of ``axis`` that holds them, in
    its local tensor, and every other shard keeps its own.  A write
    through ``sharding.assign`` gathers the whole buffer to write one
    token; this one issues no collective.  A ``local_map`` over
    ``mesh``; a ``buf`` placed so already (seq sharded over ``axis``,
    the batch over the dp axes that divide it) is written in place and
    returned, any other is redistributed first and the copy returned.
    ``slot`` is a host integer, so only the owner writes, and the buffer
    equals the plain write's bit for bit."""
    lead = (None,) * (buf.ndim - 4)
    dp = _dp_axes(mesh, buf.shape[-4])
    b_pl = SH.placements(mesh, SH.P(*lead, dp, axis, None, None))
    n_pl = SH.placements(mesh, SH.P(*lead, dp, None, None, None))

    def local(b_loc, n_loc):
        S_loc = b_loc.shape[-3]
        at = slot - mesh.get_local_rank(axis) * S_loc
        if 0 <= at < S_loc:
            b_loc[..., at:at + n_loc.shape[-3], :, :] = n_loc
        return b_loc

    buf = _on_mesh(buf, mesh)
    out = local_map(local, out_placements=list(b_pl),
                    in_placements=(b_pl, n_pl), device_mesh=mesh,
                    redistribute_inputs=True)(
        buf, _on_mesh(new_row, mesh))
    return buf if tuple(buf.placements) == b_pl else out


def _owner_writes(cache_k: torch.Tensor, mesh) -> bool:
    """The reference's condition for the owner-writes cache write: the
    mesh has a model axis that divides the buffer's slots."""
    sizes = {} if mesh is None else SH.axis_sizes(mesh)
    return "model" in sizes and cache_k.shape[-3] % sizes["model"] == 0


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 sharded_axis_mesh=None) -> KVCache:
    """Append one step (Sq=1) at the ring/linear write position, in
    place (see the module docstring).  With ``sharded_axis_mesh``, a
    mesh whose model axis divides the buffer, each of K and V is
    written by the shard that owns the slot (``_sharded_slot_update``);
    otherwise through ``sharding.assign``."""
    buf = cache.k.shape[-3]
    slot = cache.pos % buf if cache.ring else min(cache.pos, buf - 1)
    mesh = sharded_axis_mesh
    if _owner_writes(cache.k, mesh):
        k = _sharded_slot_update(cache.k, k_new, slot, mesh)
        v = _sharded_slot_update(cache.v, v_new, slot, mesh)
    else:
        key = (..., slice(slot, slot + 1), slice(None), slice(None))
        k, v = SH.assign(cache.k, key, k_new), SH.assign(cache.v, key, v_new)
    return KVCache(k=k, v=v, length=min(cache.length + 1, buf),
                   pos=cache.pos + 1, ring=cache.ring)


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
        mesh = SH.current_mesh() if cfg.decode_attn == "split_kv" else None
        new_cache = cache_update(cache, k, v, sharded_axis_mesh=mesh)
        # linear cache: slot == absolute position, so the window mask
        # applies; ring cache: the buffer is the window, and positions
        # in it are not absolute, so the mask stays off
        w_eff = 0 if cache.ring else window
        if _owner_writes(new_cache.k, mesh):
            out = decode_attention_split_kv(
                q, new_cache.k, new_cache.v, kv_valid=new_cache.length,
                window=w_eff, q_pos=new_cache.pos - 1, mesh=mesh)
        else:
            out = attention_core(
                q, new_cache.k, new_cache.v, causal=False, window=w_eff,
                q_offset=new_cache.pos - 1, kv_valid=new_cache.length,
                chunk=cfg.attn_chunk, acc_dtype=acc)
    else:
        new_cache = (k, v)   # prefill: the stack builds the cache from it
        out = attention_core(
            q, k, v, causal=causal and xa is None, window=window,
            q_offset=positions[0] if causal else 0, kv_valid=Skv,
            chunk=cfg.attn_chunk, acc_dtype=acc)
    out = SH.reshape(out, B, Sq, H * Dh) @ params["wo"].to(dt)
    return out, new_cache
