"""The layer stacks: train (differentiable), prefill and decode.

The JAX package's functional entry points stay the entry points
(``forward_train(params, cfg, tokens)``, ``prefill``, ``decode_step``,
...).  ``params`` is the flat path -> tensor dict of
``models.params.param_table`` in either layout (stacked ``layers/...``
with a leading L axis when ``cfg.scan_layers``, else ``layers_{i}/...``)
or a ``Transformer`` built from one.  Inside, ``nn.Module``s (norm,
attention, MLP, decoder layer, the model) hold the weights cast to the
compute dtype once, when they are built: the reference casts under
``jit``, and eagerly that would cast every float32 master on every
decode step.  Callers that run many steps build once (``build``) and
pass the model; the values are the same either way.  The layer loop
is a Python loop over the layers (the reference's ``lax.scan``).

Under the model mesh (``sharding.use_mesh_rules``, params placed as
DTensors by ``launch.specs``) the same code runs on DTensors: ``shard``
marks the activations at the reference's eight sites (a no-op without a
mesh), the tensors made inside the forward (positions' RoPE angles, the
zero ``aux``, a plain token batch) follow the mesh replicated, and a
decode step's cache writes run on replicated operands
(``sharding.assign``), so the stacked caches are restacked from the
layers' results (``_restacked``) where the plain path writes them in
place.

Training differentiates through the build: given the float32 masters
as a dict (tensors that require grad), ``forward_hidden`` and
``forward_train`` build the modules inside the call, so the casts to
the compute dtype are in the autograd graph, as the reference's are
under ``jit``, and the gradients land in float32 on the masters
themselves.  A stacked leaf is cast once and split with one ``unbind``
(one cast and one stack in the backward a leaf, not one a layer).  A
``Transformer`` built earlier holds copies: it serves, it does not
train.  With grad enabled the stack runs each layer under
``cfg.remat_policy`` (the reference's ``_remat``): ``"nothing"``
recomputes the whole layer in the backward
(``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of the
matrix products without batch dims (the projections; attention's
batched products are recomputed) and ``"full"`` keeps everything.  The
three give the same gradients.

Ported: the families ``dense`` and ``vlm`` (qwen, stablelm, granite,
pixtral's prefix embeddings), ``moe`` (grok-1; DeepSeek-V2 with MLA
attention and its latent decode cache, ``models.mla``), ``ssm``
(mamba2: a stack of ``models.ssm`` blocks, no MLP) and ``hybrid``
(hymba: attention, windowed but in ``cfg.global_layers``, and the SSM
on the same normed input, fused by ``_fuse_paths``, then the MLP) and
``encdec`` (whisper: an ``Encoder`` over precomputed frame embeddings,
``enc_frames`` [B, enc_seq, d_model], run without remat as the
reference runs it, and a decoder whose layers add a non-causal
cross-attention to the encoder's output between the self-attention and
the MLP).  A
MoE layer's FFN is ``models.moe``'s gather path, and the stack sums the
layers' load-balance losses into ``aux`` as the reference's
``run_stack`` does (0 for a stack without a router).  A layer's caches
are a dict, ``{"attn": KVCache or MLACache}``, ``{"ssm": SSMCache}``
and ``{"cross": CrossCache}`` as its family has them; the SSM cache is
written in place and has no length or position, and the cross K/V that
prefill computes from the encoder's output are only read by decode
(``_cross_from_cache``).  The enc-dec entry points (``encode``,
``forward_hidden``, ``forward_train``, ``prefill``) take
``enc_frames`` and raise ``ValueError`` without them (the reference
fails with an ``AttributeError``).  The leaves the reference reads as
float32 from the master (``held_f32``: the norm scales, the SSM's
``norm``, ``dt_bias``, ``a_log`` and ``d_skip``, the fusion gains) are
held in float32, the rest in the compute dtype.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch import sharding as SH
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig

__all__ = [
    "Transformer",
    "Encoder",
    "build",
    "layer_windows",
    "layer_fn",
    "run_stack",
    "forward_hidden",
    "forward_train",
    "encode",
    "prefill",
    "decode_step",
    "init_decode_caches",
]

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks."""
    if cfg.family in PORTED_FAMILIES:
        return
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported to "
        f"repro_torch; the port runs the families "
        f"{', '.join(PORTED_FAMILIES)}")


def layer_windows(cfg: ModelConfig, force_window: bool = False) -> list[int]:
    """Attention window per layer (0 = global)."""
    return [cfg.window if cfg.window and (i not in cfg.global_layers
                                          or force_window) else 0
            for i in range(cfg.n_layers)]


def layer_params(params: dict, cfg: ModelConfig, i: int,
                 prefix: str = "layers") -> dict:
    """Layer ``i``'s flat dict, from either layout."""
    if cfg.scan_layers:
        return {k: v[i] for k, v in L.sub(params, prefix).items()}
    return L.sub(params, f"{prefix}_{i}")


#: leaves, by their last path component, that the reference reads as
#: float32 from the master (``.astype(jnp.float32)``): MLA's norm
#: scales, the SSM's gated-norm scale, step bias, decay and skip, and
#: the hybrid's fusion gains
_F32_LEAVES = frozenset({"q_norm", "kv_norm", "norm", "dt_bias", "a_log",
                         "d_skip", "gain_attn", "gain_ssm"})


def held_f32(name: str) -> bool:
    """Whether a layer leaf (``"norm1/scale"``, ``"ssm/a_log"``, or a
    block's own ``"a_log"``) is held in float32: a ``Norm``'s leaves and
    ``_F32_LEAVES``; the rest is held in the compute dtype."""
    return (name.split("/", 1)[0].startswith("norm")
            or name.rsplit("/", 1)[-1] in _F32_LEAVES)


def _layer_dicts(params: dict, cfg: ModelConfig, prefix: str = "layers",
                 n_layers: int | None = None) -> list[dict]:
    """Every layer's flat dict (``n_layers`` of them, the decoder's
    ``cfg.n_layers`` by default).  A stacked leaf is cast once to the
    dtype its block holds (``held_f32``) and split by one ``unbind``."""
    n = cfg.n_layers if n_layers is None else n_layers
    if not cfg.scan_layers:
        return [L.sub(params, f"{prefix}_{i}") for i in range(n)]
    split = {k: v.to(torch.float32 if held_f32(k)
                     else cfg.compute_dtype).unbind(0)
             for k, v in L.sub(params, prefix).items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of matrix products
    without batch dims (the reference's
    ``checkpoint_dots_with_no_batch_dims``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat_policy`` (see the module docstring)."""
    if cfg.remat_policy == "full":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Weights(nn.Module):
    """One block's weights as buffers under the reference's names, cast
    once to ``dtype``, but the leaves the reference reads as float32
    (``held_f32``) to float32; ``weights`` is the flat dict the
    ``layers`` functions read."""

    def __init__(self, params: dict, dtype: torch.dtype, device=None):
        super().__init__()
        for name, t in params.items():
            self.register_buffer(name, t.to(
                device=device,
                dtype=torch.float32 if held_f32(name) else dtype))

    @property
    def weights(self) -> dict:
        return self._buffers


class Norm(Weights):
    def __init__(self, params: dict, cfg: ModelConfig, device=None):
        super().__init__(params, torch.float32, device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.norm(self.weights, self.cfg, x)


class MLP(Weights):
    def __init__(self, params: dict, cfg: ModelConfig, device=None):
        super().__init__(params, cfg.compute_dtype, device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.mlp(self.weights, self.cfg, x)


class Attention(Weights):
    """GQA attention: causal self-attention, or non-causal (the encoder,
    and cross-attention given ``xa``)."""

    def __init__(self, params: dict, cfg: ModelConfig, window: int,
                 device=None, causal: bool = True):
        super().__init__(params, cfg.compute_dtype, device)
        self.cfg = cfg
        self.window = window
        self.causal = causal

    def forward(self, x, *, positions, cache=None, angles=None, xa=None):
        return attn_mod.attn_block(
            self.weights, self.cfg, x, positions=positions,
            causal=self.causal, window=self.window, cache=cache,
            angles=angles, xa=xa)


class MLA(Weights):
    """MLA's weights in the compute dtype, its two norm scales in
    float32 (``mla._rms`` reads them so)."""

    def __init__(self, params: dict, cfg: ModelConfig, device=None):
        super().__init__(params, cfg.compute_dtype, device)
        self.cfg = cfg

    def forward(self, x, *, positions, cache=None, angles=None):
        return mla_mod.mla_block(self.weights, self.cfg, x,
                                 positions=positions, cache=cache,
                                 angles=angles)


class MoE(Weights):
    """The router, the experts and the shared experts."""

    def __init__(self, params: dict, cfg: ModelConfig, device=None):
        super().__init__(params, cfg.compute_dtype, device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor):
        return moe_mod.moe_ffn(self.weights, self.cfg, x)


class SSM(Weights):
    """The Mamba2 block: ``in_proj``, ``conv_w``, ``conv_b`` and
    ``out_proj`` in the compute dtype, ``norm``, ``dt_bias``, ``a_log``
    and ``d_skip`` in float32."""

    def __init__(self, params: dict, cfg: ModelConfig, device=None):
        super().__init__(params, cfg.compute_dtype, device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, cache=None):
        return ssm_mod.ssm_block(self.weights, self.cfg, x, cache=cache)


def _fuse_paths(gains: dict, a_out: torch.Tensor,
                s_out: torch.Tensor) -> torch.Tensor:
    """Hymba-style fusion: each path RMS-normalized in float32, times its
    float32 gain (``gains``: the layer's ``fuse/`` leaves), the mean of
    the two, cast to the attention output's dtype."""
    def _n(x):
        xf = x.float()
        return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)

    ga, gs = gains["gain_attn"].float(), gains["gain_ssm"].float()
    return (0.5 * (_n(a_out) * ga + _n(s_out) * gs)).to(a_out.dtype)


def _cross_from_cache(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (the decode
    path): ``params`` the layer's ``cross`` leaves (``wq``, ``bq``,
    ``wo``), ``ck``/``cv`` [B, enc_seq, KV, Dh]; one shot over every
    cached key at a float32 accumulator, as the reference computes it
    whatever ``cfg.attn_acc``."""
    dt = cfg.compute_dtype
    B, Sq, _ = x.shape
    H, Dh = cfg.n_heads, cfg.d_head
    q = x @ params["wq"].to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
    q = SH.reshape(q, B, Sq, H, Dh)
    out = attn_mod.attention_core(
        q, ck, cv, causal=False, window=0, q_offset=0,
        kv_valid=ck.shape[1], chunk=cfg.attn_chunk)
    return SH.reshape(out, B, Sq, H * Dh) @ params["wo"].to(dt)


def _needs_frames(cfg: ModelConfig) -> ValueError:
    return ValueError(
        f"{cfg.name}: an enc-dec config needs enc_frames [B, enc_seq, "
        f"d_model], the encoder's input")


class EncoderLayer(nn.Module):
    """norm -> non-causal self-attention -> residual -> norm -> MLP ->
    residual."""

    def __init__(self, params: dict, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = Norm(L.sub(params, "norm1"), cfg, device)
        self.attn = Attention(L.sub(params, "attn"), cfg, 0, device,
                              causal=False)
        self.norm2 = Norm(L.sub(params, "norm2"), cfg, device)
        self.mlp = MLP(L.sub(params, "mlp"), cfg, device)

    def forward(self, x, *, positions):
        a, _ = self.attn(self.norm1(x), positions=positions)
        x = x + a
        return x + self.mlp(self.norm2(x))


class Encoder(nn.Module):
    """The whisper encoder over precomputed frame embeddings (the conv
    frontend is a stub): the frames cast to the compute dtype, plus
    ``encoder/pos``, ``cfg.n_enc_layers`` ``EncoderLayer``s, then
    ``encoder/norm_f``.  Without remat, as the reference runs it."""

    def __init__(self, params: dict, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("pos", params["encoder/pos"].to(
            device=device, dtype=cfg.compute_dtype))
        self.layers = nn.ModuleList(
            EncoderLayer(lp, cfg, device)
            for lp in _layer_dicts(params, cfg, "enc_layers",
                                   cfg.n_enc_layers))
        self.norm_f = Norm(L.sub(params, "encoder/norm_f"), cfg, device)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, Se, D] -> the encoder's output [B, Se, D]."""
        x = SH.replicated(frames, self.pos).to(device=self.pos.device,
                                              dtype=self.cfg.compute_dtype)
        x = x + self.pos[: x.shape[1]]
        x = SH.shard(x, ("act_batch", "act_seq", "act_embed"))
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in self.layers:
            x = layer(x, positions=positions)
        return self.norm_f(x)


class DecoderLayer(nn.Module):
    """One layer by family: ``ssm`` norm -> SSM -> residual; the others
    norm -> attention (MLA with ``cfg.use_mla``; in ``hybrid`` beside
    the SSM on the same input, the two fused) -> residual -> (``encdec``:
    norm -> cross-attention to the encoder's output -> residual) -> norm
    -> MLP (MoE in the ``moe`` family) -> residual."""

    def __init__(self, params: dict, cfg: ModelConfig, window: int,
                 device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        fam = cfg.family
        self.norm1 = Norm(L.sub(params, "norm1"), cfg, device)
        self.attn = self.ssm = self.fuse = self.norm2 = self.moe = None
        self.mlp = self.norm_cross = self.cross = None
        if cfg.attends:
            self.attn = (MLA(L.sub(params, "attn"), cfg, device) if cfg.use_mla
                         else Attention(L.sub(params, "attn"), cfg, window,
                                        device))
        if fam in ("ssm", "hybrid"):
            self.ssm = SSM(L.sub(params, "ssm"), cfg, device)
        if fam == "hybrid":
            self.fuse = Weights(L.sub(params, "fuse"), cfg.compute_dtype,
                                device)
        if cfg.is_encdec:
            self.norm_cross = Norm(L.sub(params, "norm_cross"), cfg, device)
            self.cross = Attention(L.sub(params, "cross"), cfg, 0, device,
                                   causal=False)
        if fam != "ssm":       # a pure mamba stack has no MLP (d_ff = 0)
            self.norm2 = Norm(L.sub(params, "norm2"), cfg, device)
            if fam == "moe":
                self.moe = MoE(L.sub(params, "moe"), cfg, device)
            else:
                self.mlp = MLP(L.sub(params, "mlp"), cfg, device)

    def forward(self, x, *, positions, cache=None, angles=None,
                enc_out=None):
        """``cache``: the layer's {"attn": ..., "ssm": ..., "cross": ...}
        in decode, else None; ``enc_out``: the encoder's output, which
        the cross-attention reads where the cache has no "cross".
        Returns (x', new, aux): ``new`` has the layer's "attn" (the new
        (k, v) (MLA: (ckv, k_rope)) without a cache, else the updated
        cache), "ssm" (an ``SSMCache``) and "cross" (the new cross
        (k, v) from ``enc_out``, else the ``CrossCache`` read) as its
        family has them; aux the router's load-balance loss, None
        without a router."""
        cache = cache or {}
        new = {}
        h = SH.shard(self.norm1(x), ("act_batch", "act_seq", "act_embed"))
        if self.attn is not None:
            a, new["attn"] = self.attn(h, positions=positions,
                                       cache=cache.get("attn"), angles=angles)
        if self.ssm is not None:
            s, new["ssm"] = self.ssm(h, cache=cache.get("ssm"))
        if self.attn is None:
            x = x + s
        elif self.ssm is None:
            x = x + a
        else:
            x = x + _fuse_paths(self.fuse.weights, a, s)
        if self.cross is not None:
            hc = self.norm_cross(x)
            cc = cache.get("cross")
            if cc is not None:
                c = _cross_from_cache(self.cross.weights, self.cfg, hc,
                                      cc.k, cc.v)
                new["cross"] = cc
            elif enc_out is None:
                raise _needs_frames(self.cfg)
            else:
                c, new["cross"] = self.cross(hc, positions=positions,
                                             xa=enc_out)
            x = x + c
        x = SH.shard(x, ("act_batch", "act_seq", "act_embed"))
        if self.norm2 is None:
            return x, new, None
        h = self.norm2(x)
        if self.moe is None:
            h = SH.shard(h, ("act_batch", "act_seq", "act_embed"))
            x, aux = x + self.mlp(h), None
        else:
            y, aux = self.moe(h)
            x = x + y
        return SH.shard(x, ("act_batch", "act_seq", "act_embed")), new, aux


class Transformer(nn.Module):
    """The whole decoder, built once from a flat param dict on
    ``device`` (None = the params' own device)."""

    def __init__(self, params: dict, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dt = cfg.compute_dtype
        device = params["embed/tokens"].device if device is None else device
        self.embed = Weights({"tokens": params["embed/tokens"]}, dt, device)
        if cfg.pos == "learned":
            self.embed.register_buffer(
                "pos", params["embed/pos"].to(device=device, dtype=dt))
        self.encoder = (Encoder(params, cfg, device) if cfg.is_encdec
                        else None)
        windows = layer_windows(cfg)
        self.layers = nn.ModuleList(
            DecoderLayer(lp, cfg, windows[i], device)
            for i, lp in enumerate(_layer_dicts(params, cfg)))
        self.norm_f = Norm(L.sub(params, "norm_f"), cfg, device)
        head = {} if cfg.tie_embeddings else {"lm_head": params["lm_head"]}
        self.head = Weights(head, dt, device)

    @property
    def device(self) -> torch.device:
        return self.embed.tokens.device

    def embed_input(self, tokens, prefix_embeds=None) -> torch.Tensor:
        """tokens [B, St] (+ prefix embeds [B, Pfx, D]) -> [B, S, D]."""
        table = _one_use(self.embed.tokens)
        x = table[SH.replicated(tokens, table).to(self.device)]
        if prefix_embeds is not None:
            x = torch.cat([SH.replicated(prefix_embeds, x).to(
                device=x.device, dtype=x.dtype), x], dim=1)
        if self.cfg.pos == "learned":
            x = x + self.embed.pos[: x.shape[1]]
        return x

    def encode(self, frames) -> torch.Tensor:
        """The encoder's output for ``frames`` [B, enc_seq, d_model];
        ``ValueError`` without them."""
        if frames is None:
            raise _needs_frames(self.cfg)
        return self.encoder(frames)

    def run_stack(self, x, *, positions, caches=None, remat: bool = False,
                  enc_out=None):
        """Every layer in turn.  Returns (x, new, aux): without caches
        the per-layer dicts of ``DecoderLayer.forward``, with them the
        caches dict, its attention cache advanced (the SSM cache is
        updated in place, the cross cache only read); aux the layers'
        load-balance losses summed in layer order (float32, 0 without a
        router).  ``remat``: run each layer under ``cfg.remat_policy``
        when grad is enabled (the train mode).  ``enc_out``: the
        encoder's output, for an enc-dec stack without caches."""
        cfg = self.cfg
        angles = None
        if cfg.use_mla:      # MLA rotates qk_rope_dim lanes, whatever pos
            angles = L.rope_angles(positions, cfg, cfg.qk_rope_dim,
                                   cfg.qk_rope_dim)
        elif cfg.attends and cfg.pos == "rope":
            angles = L.rope_angles(positions, cfg, cfg.d_head)
        if angles is not None:   # replicated under a mesh
            angles = tuple(SH.replicated(a, x) for a in angles)
        remat = remat and caches is None and torch.is_grad_enabled()
        news, aux = [], None
        for i, layer in enumerate(self.layers):
            cache = ({k: c.layer(i) for k, c in caches.items()}
                     if caches is not None else None)
            call = _remat(layer, cfg) if remat else layer
            x, new, a = call(x, positions=positions, cache=cache,
                             angles=angles, enc_out=enc_out)
            if a is not None:
                aux = a if aux is None else aux + a
            news.append(new)
        aux = _zero_aux(x) if aux is None else aux
        if caches is None:
            return x, news, aux
        caches = dict(caches)
        c = caches.get("attn")
        if isinstance(c, mla_mod.MLACache):
            ckv, krope = _restacked(c.ckv, news, "attn", "ckv"), \
                _restacked(c.krope, news, "attn", "krope")
            caches["attn"] = mla_mod.MLACache(
                ckv=ckv, krope=krope,
                length=min(c.length + 1, c.ckv.shape[-2]), pos=c.pos + 1)
        elif c is not None:
            caches["attn"] = attn_mod.KVCache(
                k=_restacked(c.k, news, "attn", "k"),
                v=_restacked(c.v, news, "attn", "v"),
                length=min(c.length + 1, c.k.shape[-3]),
                pos=c.pos + 1, ring=c.ring)
        c = caches.get("ssm")
        if c is not None:
            caches["ssm"] = ssm_mod.SSMCache(
                conv=_restacked(c.conv, news, "ssm", "conv"),
                state=_restacked(c.state, news, "ssm", "state"))
        return x, caches, aux

    def unembed(self, h) -> torch.Tensor:
        """Logits of final-normed hidden states ``h``."""
        return L.unembed({"embed/tokens": _one_use(self.embed.tokens),
                          **self.head.weights}, self.cfg, h)


def build(params, cfg: ModelConfig, device=None) -> Transformer:
    """``params`` as a ``Transformer`` (built from a flat dict, or as
    given when it already is one)."""
    if isinstance(params, Transformer):
        return params
    return Transformer(params, cfg, device)


def _one_use(w: torch.Tensor) -> torch.Tensor:
    """``w`` for one of its uses: a DTensor's gradient from this use is
    placed as ``w`` is, so that the gradients of the tied table's two
    uses (lookup and unembed) add in one placement (some DTensor
    releases cannot add a sharded one to a partial one)."""
    if not isinstance(w, DTensor):
        return w
    return SH.redistribute(w, w.placements)


def _zero_aux(like: torch.Tensor) -> torch.Tensor:
    """A float32 zero on ``like``'s device (replicated under a mesh)."""
    return SH.replicated(
        torch.zeros((), dtype=torch.float32, device=like.device), like)


def _restacked(buf: torch.Tensor, news: list[dict], kind: str,
               field: str) -> torch.Tensor:
    """A stacked decode cache after the step: a plain buffer was written
    in place by every layer; a DTensor's layers were written out of
    place (``sharding.assign``) and are stacked anew."""
    if not isinstance(buf, DTensor):
        return buf
    return torch.stack([getattr(n[kind], field) for n in news])


def layer_fn(params: dict, cfg: ModelConfig, x, *, positions, window: int,
             mode: str, cache=None, enc_out=None):
    """One decoder layer from its flat dict. mode: train | prefill |
    decode; ``cache``: the layer's {"attn": KVCache or MLACache, "ssm":
    SSMCache, "cross": CrossCache} (as its family has them) or None;
    ``enc_out``: the encoder's output (enc-dec, without a cross cache).
    Returns (x', new_cache, aux), ``new_cache`` with the family's keys
    (None in train)."""
    layer = DecoderLayer(params, cfg, window, x.device)
    x, new, aux = layer(x, positions=positions, cache=cache, enc_out=enc_out)
    return (x, {k: v if mode != "train" else None for k, v in new.items()},
            _zero_aux(x) if aux is None else aux)


def _stack_ssm(news: list[dict]) -> ssm_mod.SSMCache:
    """The layers' prefill ``SSMCache``s stacked on a leading L axis."""
    return ssm_mod.SSMCache(conv=torch.stack([n["ssm"].conv for n in news]),
                            state=torch.stack([n["ssm"].state for n in news]))


def _stack_cross(news: list[dict]) -> attn_mod.CrossCache:
    """The layers' prefill cross (k, v) as one ``CrossCache`` on a
    leading L axis."""
    return attn_mod.CrossCache(*(torch.stack([n["cross"][j] for n in news])
                                 for j in range(2)))


def _stack_layers(news: list[dict]) -> dict:
    """Per-layer prefill outputs stacked on a leading L axis: "attn" the
    (k, v) (MLA: (ckv, k_rope)) pair, "ssm" an ``SSMCache``, "cross" a
    ``CrossCache``."""
    out = {}
    if "attn" in news[0]:
        out["attn"] = tuple(torch.stack([n["attn"][j] for n in news])
                            for j in range(2))
    if "ssm" in news[0]:
        out["ssm"] = _stack_ssm(news)
    if "cross" in news[0]:
        out["cross"] = _stack_cross(news)
    return out


def run_stack(params, cfg: ModelConfig, x, *, positions, mode: str,
              caches=None, enc_out=None):
    """The layer stack.  Returns (x, stacked caches, aux): prefill's
    {"attn": (k, v) (MLA: (ckv, k_rope)), "ssm": SSMCache, "cross":
    CrossCache} (as the family has them) stacked on a leading L axis,
    decode's advanced caches, None in train.  ``enc_out``: the
    encoder's output (enc-dec, without caches)."""
    model = build(params, cfg, x.device)
    x, new, aux = model.run_stack(x, positions=positions, caches=caches,
                                  remat=mode == "train", enc_out=enc_out)
    if mode == "train":
        return x, None, aux
    if caches is not None:
        return x, new, aux
    return x, _stack_layers(new), aux


def _positions(start: int, S: int, device) -> torch.Tensor:
    return torch.arange(start, start + S, device=device)


def encode(params, cfg: ModelConfig, frames) -> torch.Tensor:
    """The whisper encoder over precomputed frame embeddings ``frames``
    [B, Se, D] (the conv frontend is a stub) -> [B, Se, D]."""
    return build(params, cfg).encode(frames)


def forward_hidden(params, cfg: ModelConfig, tokens, prefix_embeds=None,
                   enc_frames=None):
    """Teacher-forced final hidden states [B, S, D] (pre-unembed) + aux;
    differentiable with respect to a master dict ``params``.  An enc-dec
    config encodes ``enc_frames`` first (the encoder without remat)."""
    model = build(params, cfg)
    enc_out = model.encode(enc_frames) if cfg.is_encdec else None
    x = model.embed_input(tokens, prefix_embeds)
    x = SH.shard(x, ("act_batch", "act_seq", "act_embed"))
    x, _, aux = model.run_stack(
        x, positions=_positions(0, x.shape[1], x.device), remat=True,
        enc_out=enc_out)
    return model.norm_f(x), aux


def forward_train(params, cfg: ModelConfig, tokens, prefix_embeds=None,
                  enc_frames=None):
    """Teacher-forced logits for training. Returns (logits, aux_loss)."""
    model = build(params, cfg)
    h, aux = forward_hidden(model, cfg, tokens, prefix_embeds, enc_frames)
    logits = SH.shard(model.unembed(h), ("act_batch", "act_seq", "act_vocab"))
    return logits, aux


def init_decode_caches(cfg: ModelConfig, batch: int, buf_len: int,
                       long_context: bool = False, device=None) -> dict:
    """Stacked (L-leading) caches for decode: "ssm" for the ``ssm`` and
    ``hybrid`` families; "attn" for every family that attends: MLA's
    latent cache with ``cfg.use_mla``, else K/V in a ring buffer of the
    window's size when ``long_context`` and the config has a window;
    "cross" for ``encdec``, zero cross K/V of ``cfg.enc_seq`` slots
    (a decode from them attends over zeros, as the reference's does)."""
    check_ported(cfg)
    caches = {}
    if cfg.use_mla:
        caches["attn"] = mla_mod.init_mla_cache(
            cfg, batch, buf_len, layers=cfg.n_layers, device=device)
    elif cfg.attends:
        ring = long_context and cfg.window > 0
        buf = min(buf_len, cfg.window) if ring else buf_len
        caches["attn"] = attn_mod.init_cache(
            cfg, batch, buf, cfg.n_kv_heads, cfg.d_head, ring=ring,
            layers=cfg.n_layers, device=device)
    if cfg.family in ("ssm", "hybrid"):
        caches["ssm"] = ssm_mod.init_ssm_cache(cfg, batch,
                                               layers=cfg.n_layers,
                                               device=device)
    if cfg.is_encdec:
        shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads,
                 cfg.d_head)
        caches["cross"] = attn_mod.CrossCache(*(
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
            for _ in range(2)))
    return caches


def prefill(params, cfg: ModelConfig, tokens, prefix_embeds=None,
            enc_frames=None, buf_len: int | None = None):
    """Process a prompt, return (last-position logits [B, V], caches).

    enc_frames: an enc-dec config's encoder input [B, enc_seq, d_model];
    buf_len: KV-buffer capacity for subsequent decode (>= prompt
    length); defaults to prompt length + 64.
    """
    model = build(params, cfg)
    enc_out = model.encode(enc_frames) if cfg.is_encdec else None
    x = model.embed_input(tokens, prefix_embeds)
    x = SH.shard(x, ("act_batch", "act_seq", "act_embed"))
    S = x.shape[1]
    x, news, _ = model.run_stack(x, positions=_positions(0, S, x.device),
                                 enc_out=enc_out)
    logits = model.unembed(model.norm_f(x[:, -1:]))
    caches = _assemble_prefill_caches(cfg, news, S,
                                      buf_len if buf_len else S + 64)
    return logits[:, 0], caches


def _assemble_prefill_caches(cfg: ModelConfig, news: list[dict], S: int,
                             buf_len: int) -> dict:
    """Per-layer prefill outputs (``DecoderLayer.forward``'s dicts) into
    decode-ready stacked caches: the (k, v) [B, S, KV, Dh] (MLA: (ckv,
    k_rope) [B, S, kv_lora] and [B, S, qk_rope_dim]) into one linear
    cache of ``max(buf_len, S)`` slots, zero past the prompt; the SSM
    caches and the cross K/V stacked on a leading L axis."""
    caches = {"ssm": _stack_ssm(news)} if "ssm" in news[0] else {}
    if "cross" in news[0]:
        caches["cross"] = _stack_cross(news)
    if "attn" not in news[0]:
        return caches
    stacked = []
    for j in range(2):
        x0 = news[0]["attn"][j]
        if isinstance(x0, DTensor):
            # no in-place slice write into a DTensor: stacked, then
            # padded with zeros past the prompt
            stk = torch.stack([n["attn"][j] for n in news])
            stacked.append(SH.pad(stk, (0, 0) * (stk.ndim - 3)
                                  + (0, max(buf_len, S) - S)))
            continue
        buf = x0.new_zeros((cfg.n_layers, x0.shape[0], max(buf_len, S))
                           + x0.shape[2:])
        for i, n in enumerate(news):
            buf[i, :, :S] = n["attn"][j]
        stacked.append(buf)
    if cfg.use_mla:
        caches["attn"] = mla_mod.MLACache(ckv=stacked[0], krope=stacked[1],
                                          length=S, pos=S)
    else:
        caches["attn"] = attn_mod.KVCache(k=stacked[0], v=stacked[1],
                                          length=S, pos=S, ring=False)
    return caches


def decode_step(params, cfg: ModelConfig, caches: dict, token, pos):
    """One decode step: token [B] int, pos (int or 0-d) the token's
    absolute position.  -> (logits [B, V], caches), the caches updated
    in place (``models.attention``, ``models.ssm``)."""
    model = build(params, cfg)
    pos = int(pos)
    table = model.embed.tokens
    x = table[SH.replicated(token, table).to(model.device)[:, None]]
    if cfg.pos == "learned":
        x = x + model.embed.pos[min(max(pos, 0), cfg.max_seq - 1)]
    x, caches, _ = model.run_stack(
        x, positions=_positions(pos, 1, x.device), caches=caches)
    return model.unembed(model.norm_f(x))[:, 0], caches
