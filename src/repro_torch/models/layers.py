"""Shared primitive layers: norms, RoPE, MLPs, embeddings.

Functions over flat param dicts (path -> tensor), as in the JAX package.
``sub(params, p)`` narrows to a prefix so blocks compose: attention reads
"wq", the layer passes ``sub(params, "attn")``.  Weights are cast to the
compute dtype where they are read; ``.to`` of a tensor already in that
dtype returns it unchanged, so the modules of ``models.transformer``,
which hold copies cast once when they are built, pay nothing here.

The JAX package's numerics, kept: ``jnp.var`` is the population
variance (``unbiased=False``), ``jax.nn.gelu`` the tanh approximation,
RoPE the half-split layout with its angles in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH
from repro_torch.models.config import ModelConfig

__all__ = ["sub", "norm", "rope", "mlp", "embed_tokens", "unembed"]


def sub(params: dict, prefix: str) -> dict:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def norm(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm in fp32, cast back to the input's dtype."""
    dt = x.dtype
    xf = x.float()
    scale = params["scale"].float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = ((xf - mean) * torch.rsqrt(var + 1e-5) * scale
               + params["bias"].float())
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * scale
    return out.to(dt)


def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] -> (cos, sin) of shape [..., dim//2], float32."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def rope_width(cfg: ModelConfig, d_head: int, dim: int | None = None) -> int:
    """How many of a head's ``d_head`` lanes RoPE rotates."""
    rot = dim if dim is not None else int(d_head * cfg.rope_pct)
    return max(2, (rot // 2) * 2)


def rope_angles(positions: torch.Tensor, cfg: ModelConfig, d_head: int,
                dim: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) that ``rope`` applies at ``positions``: computed once a
    forward pass by the model and shared by every layer's q and k."""
    return _rope_angles(positions, rope_width(cfg, d_head, dim),
                        cfg.rope_theta)


def rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
         dim: int | None = None, *, angles=None) -> torch.Tensor:
    """Rotary embedding on the last dim (partial when cfg.rope_pct < 1).

    x: [..., S, H, Dh]; positions: [S] or [..., S] absolute positions.
    The GPT-NeoX "half-split" layout: the first half of the rotated
    width pairs with the second.  ``angles``: ``rope_angles`` of the
    same positions, when the caller has them.
    """
    rot = rope_width(cfg, x.shape[-1], dim)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    cos, sin = (angles if angles is not None
                else _rope_angles(positions, rot, cfg.rope_theta))
    # the angles follow x's mesh (replicated) under a mesh
    cos = SH.replicated(cos, x)[..., None, :]    # broadcast over heads
    sin = SH.replicated(sin, x)[..., None, :]
    x1, x2 = x_rot.chunk(2, dim=-1)
    r1 = x1 * cos - x2 * sin       # float32, as the reference promotes
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2, x_pass.to(r1.dtype)], dim=-1)
    return out.to(x.dtype)


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    if cfg.act == "silu_glu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        return (F.silu(g) * u) @ params["w_down"].to(dt)
    h = x @ params["w_in"].to(dt) + params["b_in"].to(dt)
    h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"].to(dt) + params["b_out"].to(dt)


def embed_tokens(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings (a row gather of the table)."""
    table = params["embed/tokens"].to(cfg.compute_dtype)
    return table[tokens]


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embed/tokens"].to(cfg.compute_dtype).T
    else:
        w = params["lm_head"].to(cfg.compute_dtype)
    logits = x @ w
    if cfg.logit_cap > 0:
        logits = cfg.logit_cap * torch.tanh(logits / cfg.logit_cap)
    return logits
