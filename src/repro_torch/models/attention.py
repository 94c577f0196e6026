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
DTensors.  Where the model axis has more than one rank, train and
prefill run ``attn_heads``, a ``local_map`` in which each rank projects,
attends over and out-projects only its heads (``torch.chunk``'s split
of them, the KV heads they read), so that no view into heads gathers
the heads; prefill's new K/V leave it placed as the decode cache.
Elsewhere the positions' masks made inside the block follow the mesh
replicated and the running max, sum and accumulator are built on each
rank at the local shape of the queries' shard (``_stat_like``).
Decode takes a seq-sharded cache as it is: the slot's owner writes it
(``_sharded_slot_update``, in place and with no collective) and the
scores and ``p . v`` contract over the seq shards
(``sharding.einsum``); a cache placed otherwise is written on
replicated operands (``sharding.assign``), as GSPMD writes it.  With
``decode_attn="split_kv"`` decode attention takes the reference's
explicit path (``decode_attention_split_kv``), in which each seq shard
of the cache computes the partial softmax stats over its slice and the
shards combine them with functional all-reduces (max, then sums) over
the model axis.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rope

__all__ = ["attention_core", "attn_block", "KVCache", "CrossCache",
           "init_cache", "cache_update", "decode_attention_split_kv"]

NEG_INF = -1e30


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
    dp = SH.dp_axes(mesh, B)
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
        # decode's one chunk is the whole buffer: not sliced, so a
        # seq-sharded cache stays on its shards
        kc = (k if chunk == k.shape[1] else k[:, start:start + chunk]).to(
            acc_dtype)
        vc = (v if chunk == v.shape[1] else v[:, start:start + chunk]).to(
            acc_dtype)
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
        # this chunk's scores freed before the next chunk's are made
        del s, p
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


def attn_heads(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
               positions, causal: bool, window: int, angles=None,
               xa: torch.Tensor | None = None, kv=None, keep_kv: bool = True,
               acc_dtype: torch.dtype | None = None):
    """``attn_block`` without a decode cache on a model mesh whose model
    axis has more than one rank (``sharding.model_split``): a
    ``local_map`` that keeps the heads on their shards.  The model axis's
    rank r takes the q heads ``sharding.head_range(H, model, r)`` (at
    most ceil(H / model); the last ranks fewer or none where the heads
    do not divide the axis) and the KV heads they read (q head h reads
    KV head h // G), projects only those (a weight whose model shard
    holds whole heads of this split, wq/wo where H divides the axis and
    wk/wv where KV does, is read as its shard; another is gathered over
    the axis and its heads' columns taken), attends over them with
    ``attention_core`` on local tensors, and multiplies its heads' rows
    of wo: the output [B, Sq, D] is ``Partial`` (a sum over the model
    axis), its batch on the dp axes.  ``kv``: a given (k, v) [B, Skv,
    KV, Dh] (decode's cross cache) in place of projecting ``xa``;
    ``acc_dtype``: attention's accumulator (default by
    ``cfg.attn_acc``).

    With ``keep_kv`` (and no ``kv``) it also returns the new (k, v)
    placed as the cache's rule axes (("act_batch", "act_seq_cache",
    "act_kv_cache", None)) place them: each KV head's first reader owns
    it, and one all-to-all a tensor over the model axis moves the owned
    heads to the seq chunks (or, where the seq does not divide the axis,
    to every rank); where KV divides the axis each rank's heads are
    already its shard.  No rank holds a whole but its heads' q, K, V and
    scores."""
    mesh = x.device_mesh
    dt = cfg.compute_dtype
    B, Sq, D = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KV
    mi, M, r = SH.model_axis(mesh)
    group = mesh.get_group("model")
    h0, h1 = SH.head_range(H, M, r)
    nh = h1 - h0
    g0 = h0 // G
    g1 = -(-h1 // G) if nh else g0
    q_whole, kv_whole = H % M == 0, KV % M == 0
    bat = SH.dp_axes(mesh, B)
    src = xa if xa is not None else x
    Skv = (kv[0] if kv is not None else src).shape[1]

    def pl(*spec):
        return SH.placements(mesh, SH.P(*spec))

    x_pl = pl(bat, None, None)
    names = ["wq", "wk", "wv", "wo"] + [b for b in ("bq", "bk", "bv")
                                         if b in params]
    w_pl = {"wq": pl(None, "model" if q_whole else None),
            "wo": pl("model" if q_whole else None, None),
            "bq": pl("model" if q_whole else None)}
    for n in ("wk", "wv"):
        w_pl[n] = pl(None, "model" if kv_whole else None)
    for n in ("bk", "bv"):
        w_pl[n] = pl("model" if kv_whole else None)
    if kv is not None:
        names = [n for n in names if n not in ("wk", "wv", "bk", "bv")]
    kv_in_pl = pl(bat, None, "model" if kv_whole else None, None)
    # the new (k, v) leave placed as the cache: seq chunks, whole heads
    # of this split, or every head on every rank
    p = SH.logical_placements(
        ("act_batch", "act_seq_cache", "act_kv_cache", None),
        (B, Skv, KV, Dh))[mi]
    mode = ("seq" if p == Shard(1) else "heads" if p == Shard(2)
            and kv_whole else None)
    kv_out_pl = pl(bat, "model" if mode == "seq" else None,
                   "model" if mode == "heads" else None, None)
    # the KV heads each rank owns: those whose first reader it holds
    own = []
    for s in range(M):
        a, b = SH.head_range(H, M, s)
        own.append(max(0, (-(-b // G) if b > a else 0) - (-(-a // G))))

    def cols(w, lo, hi, whole, dim=-1):
        return w if whole else w.narrow(dim, lo * Dh, (hi - lo) * Dh)

    def local(x_l, *rest):
        rest = list(rest)
        cos_sin = None
        if angles is not None:
            cos_sin = (rest.pop(0), rest.pop(0))
        xa_l = rest.pop(0) if xa is not None else None
        kv_l = (rest.pop(0), rest.pop(0)) if kv is not None else None
        w = dict(zip(names, rest))
        Bl = x_l.shape[0]
        q = x_l @ cols(w["wq"], h0, h1, q_whole)
        if "bq" in w:
            q = q + cols(w["bq"], h0, h1, q_whole)
        q = q.reshape(Bl, Sq, nh, Dh)
        if kv_l is None:
            s_l = xa_l if xa_l is not None else x_l
            k = s_l @ cols(w["wk"], g0, g1, kv_whole)
            v = s_l @ cols(w["wv"], g0, g1, kv_whole)
            if "bk" in w:
                k = k + cols(w["bk"], g0, g1, kv_whole)
                v = v + cols(w["bv"], g0, g1, kv_whole)
            k = k.reshape(Bl, Skv, g1 - g0, Dh)
            v = v.reshape(Bl, Skv, g1 - g0, Dh)
        else:
            k, v = (t if kv_whole else t[:, :, g0:g1] for t in kv_l)
        if cfg.pos == "rope" and xa is None and kv is None:
            q = rope(q, positions, cfg, angles=cos_sin)
            k = rope(k, positions, cfg, angles=cos_sin)
        if nh:
            counts = torch.bincount(
                torch.arange(h0, h1) // G - g0, minlength=g1 - g0)
            ka, va = k, v
            if int(counts.min()) != int(counts.max()):
                # this rank's heads split the groups unevenly: each q
                # head reads a copy of its KV head
                ka = k.repeat_interleave(counts.to(k.device), dim=2)
                va = v.repeat_interleave(counts.to(v.device), dim=2)
            acc = acc_dtype or (torch.bfloat16 if cfg.attn_acc == "bf16"
                                else torch.float32)
            o = attention_core(
                q, ka, va, causal=causal, window=window,
                q_offset=positions[0] if causal else 0, kv_valid=Skv,
                chunk=cfg.attn_chunk, acc_dtype=acc)
        else:
            # no heads here: an empty result that still reads every
            # input, so that each rank's backward runs the same
            # collectives
            o = q + 0 * (k.sum() + v.sum())
        wo = cols(w["wo"], h0, h1, q_whole, dim=0)
        out = o.reshape(Bl, Sq, nh * Dh) @ wo
        if not keep_kv or kv is not None:
            return out
        lo = -(-h0 // G) - g0 if nh else 0
        k_own = k.narrow(2, lo, own[r])
        v_own = v.narrow(2, lo, own[r])
        if mode != "heads":
            seq = M if mode == "seq" else None
            k_own = SH.exchange(k_own, own, 2, seq, group)
            v_own = SH.exchange(v_own, own, 2, seq, group)
        return out, k_own, v_own

    ins, in_pl = [x], [x_pl]
    if angles is not None:
        ins += [SH.replicated(a, x) for a in angles]
        in_pl += [pl(*([None] * a.ndim)) for a in angles]
    if xa is not None:
        ins.append(SH.replicated(xa, x))
        in_pl.append(x_pl)
    if kv is not None:
        ins += [SH.replicated(t, x) for t in kv]
        in_pl += [kv_in_pl] * 2
    ins += [SH.replicated(params[n], x) for n in names]
    in_pl += [w_pl[n] for n in names]
    out_pl = tuple(Partial() if i == mi else p for i, p in enumerate(x_pl))
    outs = [out_pl] if not keep_kv or kv is not None else \
        [out_pl, kv_out_pl, kv_out_pl]
    res = local_map(local, out_placements=tuple(outs) if len(outs) > 1
                    else list(outs[0]),
                    in_placements=tuple(in_pl),
                    in_grad_placements=tuple(SH.summed_grads(mesh, p)
                                             for p in in_pl),
                    device_mesh=mesh, redistribute_inputs=True)(*ins)
    if not keep_kv or kv is not None:
        return res, None
    return res[0], (res[1], res[2])


def _sharded_slot_update(buf: torch.Tensor, new_row: torch.Tensor,
                         slot: int, mesh, axis: str = "model",
                         seq_dim: int = -3) -> torch.Tensor:
    """Owner-writes update of a seq-sharded buffer, seq at ``seq_dim`` (a
    negative dim, the batch just before it: -3 for K/V [..., B, S_buf,
    KV, Dh], -2 for MLA's latents [..., B, S_buf, L]): the rows of
    ``new_row`` go to slots ``slot ..`` of the one shard of ``axis``
    that holds them, in its local tensor, and every other shard keeps
    its own.  A write through ``sharding.assign`` gathers the whole
    buffer to write one token; this one issues no collective.  A
    ``local_map`` over ``mesh``; a ``buf`` placed so already (seq
    sharded over ``axis``, the batch over the dp axes that divide it)
    is written in place and returned, any other is redistributed first
    and the copy returned.  ``slot`` is a host integer, so only the
    owner writes, and the buffer equals the plain write's bit for
    bit."""
    seq = buf.ndim + seq_dim
    lead, tail = (None,) * (seq - 1), (None,) * (-seq_dim - 1)
    dp = SH.dp_axes(mesh, buf.shape[seq - 1])
    b_pl = SH.placements(mesh, SH.P(*lead, dp, axis, *tail))
    n_pl = SH.placements(mesh, SH.P(*lead, dp, None, *tail))

    def local(b_loc, n_loc):
        S_loc = b_loc.shape[seq]
        at = slot - mesh.get_local_rank(axis) * S_loc
        if 0 <= at < S_loc:
            b_loc.narrow(seq, at, n_loc.shape[seq]).copy_(n_loc)
        return b_loc

    buf = _on_mesh(buf, mesh)
    out = local_map(local, out_placements=list(b_pl),
                    in_placements=(b_pl, n_pl), device_mesh=mesh,
                    redistribute_inputs=True)(
        buf, _on_mesh(new_row, mesh))
    return buf if tuple(buf.placements) == b_pl else out


def _seq_sharded(cache_k: torch.Tensor, mesh, seq_dim: int = -3) -> bool:
    """Whether a decode cache buffer (seq at ``seq_dim``: K/V [..., B,
    S_buf, KV, Dh], MLA's latents [..., B, S_buf, L] at -2) is a DTensor
    whose seq dim the mesh's model axis shards (as
    ``launch.specs.cache_shardings`` places it)."""
    if not isinstance(cache_k, DTensor) or not _owner_writes(
            cache_k, mesh, seq_dim):
        return False
    mi = tuple(mesh.mesh_dim_names).index("model")
    return cache_k.placements[mi] == Shard(cache_k.ndim + seq_dim)


def _owner_writes(cache_k: torch.Tensor, mesh, seq_dim: int = -3) -> bool:
    """The reference's condition for the owner-writes cache write: the
    mesh has a model axis that divides the buffer's slots (its dim
    ``seq_dim``)."""
    sizes = {} if mesh is None else SH.axis_sizes(mesh)
    return "model" in sizes and cache_k.shape[seq_dim] % sizes["model"] == 0


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
    keep_kv: bool = True,         # return prefill's new (k, v)
):
    """Full GQA block: qkv proj, rope, core, out proj.

    Returns (out [B,Sq,D], new_cache): in prefill (and with ``xa``) the
    new (k, v) (None without ``keep_kv``), in decode the updated cache.
    On the model mesh, train and prefill run ``attn_heads``; decode
    takes a seq-sharded cache as it is: the token's q, k and v are
    gathered over the model axis (a [B, 1, H, Dh] view gathers no
    heads), the owner of the slot writes it, and attention contracts
    over the cache's seq shards (``sharding.einsum``).
    """
    dt = cfg.compute_dtype
    B, Sq, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    mesh = SH.current_mesh()
    if (cache is None or xa is not None) and SH.model_split(x):
        return attn_heads(params, cfg, x, positions=positions,
                          causal=causal and xa is None, window=window,
                          angles=angles, xa=xa, keep_kv=keep_kv)
    seq_cache = (cache is not None and xa is None
                 and _seq_sharded(cache.k, mesh))

    def heads_whole(t):
        # a decode step's [B, 1, heads x Dh] gathered over the model
        # axis, so that its view into heads gathers nothing
        if not seq_cache or not isinstance(t, DTensor):
            return t
        return SH.redistribute(t, tuple(
            Replicate() if isinstance(p, Shard) and p.dim == t.ndim - 1
            else p for p in t.placements))

    q = x @ params["wq"].to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
    q = SH.reshape(heads_whole(q), B, Sq, H, Dh)
    kv_src = xa if xa is not None else x
    Skv = kv_src.shape[1]
    k = kv_src @ params["wk"].to(dt)
    v = kv_src @ params["wv"].to(dt)
    if "bk" in params:
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    k = SH.reshape(heads_whole(k), B, Skv, KV, Dh)
    v = SH.reshape(heads_whole(v), B, Skv, KV, Dh)

    if cfg.pos == "rope" and xa is None:
        q = rope(q, positions, cfg, angles=angles)
        k = rope(k, positions, cfg, angles=angles)

    acc = torch.bfloat16 if cfg.attn_acc == "bf16" else torch.float32
    if cache is not None and xa is None:
        split = cfg.decode_attn == "split_kv"
        new_cache = cache_update(cache, k, v, sharded_axis_mesh=mesh
                                 if split or seq_cache else None)
        # linear cache: slot == absolute position, so the window mask
        # applies; ring cache: the buffer is the window, and positions
        # in it are not absolute, so the mask stays off
        w_eff = 0 if cache.ring else window
        if split and _owner_writes(new_cache.k, mesh):
            out = decode_attention_split_kv(
                q, new_cache.k, new_cache.v, kv_valid=new_cache.length,
                window=w_eff, q_pos=new_cache.pos - 1, mesh=mesh)
        else:
            out = attention_core(
                q, new_cache.k, new_cache.v, causal=False, window=w_eff,
                q_offset=new_cache.pos - 1, kv_valid=new_cache.length,
                chunk=cfg.attn_chunk, acc_dtype=acc)
    else:
        # prefill: the stack builds the cache from it
        new_cache = (k, v) if keep_kv else None
        out = attention_core(
            q, k, v, causal=causal and xa is None, window=window,
            q_offset=positions[0] if causal else 0, kv_valid=Skv,
            chunk=cfg.attn_chunk, acc_dtype=acc)
    out = SH.reshape(out, B, Sq, H * Dh) @ params["wo"].to(dt)
    return out, new_cache
