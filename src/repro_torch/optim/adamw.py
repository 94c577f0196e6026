"""AdamW with cosine schedule, global-norm clipping, and optional int8
block-quantized moments.

The JAX package's optimizer on torch tensors: the state is a dict with
its keys (``m``, ``v``, ``step``) mirroring the params, updates are
functional (new tensors; the inputs are not written), and every float32
operation is the reference's, in its order.  A quantized moment is a
``Moment`` of int8 codes plus a float32 absmax scale a block of 128 of
the last dim, dequantized inside the update.  ``torch.round`` and
``jnp.round`` both round half to even, so codes and scales of the same
values are identical in both packages.

The update makes each float32 temporary of a leaf once and then updates
it in place wherever the reference's expression allows: the same
operations in the same order, so the same values, with at most three
full-size float32 copies of a leaf alive at a time (a stacked expert
leaf of DeepSeek-V2 holds 1.26 B elements, 5 GB in float32).

Under the model mesh the masters, gradients and moments are DTensors.
The update is the same expressions on them; each new leaf is placed as
its old one was (the reference's ``out_shardings``).  A quantized
moment's codes and scales are placed by their own shapes, with the
reference's fallback to replication where a dim does not divide
(``launch.specs.state_shardings``), so codes and scales of one moment
may differ in placement; quantizing and dequantizing run on both with
the last dim gathered, so that a block of 128 never straddles two
ranks, and the result is placed back.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding import placed_as

__all__ = ["OptConfig", "Moment", "init_opt_state", "adamw_update",
           "cosine_lr", "global_norm"]

_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # "float32" | "int8"


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Warmup then cosine decay to 10% of ``cfg.lr``, in float32, on
    ``step``'s device (the CPU for a host integer)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(prog, 0.0, 1.0)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, 0.1 + 0.9 * cos)


# --- int8 blockwise quantization ------------------------------------------

def _pad_len(n: int) -> int:
    return (-n) % _BLOCK


def _quantize(x: torch.Tensor):
    """fp32 [..., d] -> (int8 codes [..., d_pad], fp32 scales [..., d_pad/B])."""
    pad = _pad_len(x.shape[-1])
    xp = F.pad(x, (0, pad)) if pad else x
    blocks = xp.reshape(xp.shape[:-1] + (-1, _BLOCK))
    # the absmax without a full-size |x|
    absmax = torch.maximum(blocks.amax(-1, keepdim=True),
                           -blocks.amin(-1, keepdim=True))
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    codes = (blocks / scale).round_().clamp_(-127, 127).to(torch.int8)
    return codes.reshape(xp.shape), scale[..., 0]


def _dequantize(codes: torch.Tensor, scale: torch.Tensor, d: int):
    blocks = codes.reshape(codes.shape[:-1] + (-1, _BLOCK)).to(torch.float32)
    x = blocks.mul_(scale[..., None])
    return x.reshape(codes.shape)[..., :d]


def _rows(t: DTensor) -> tuple:
    """``t``'s placements with its last dim gathered."""
    last = t.ndim - 1
    return tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                 else p for p in t.placements)


def _from_rows(local: torch.Tensor, mesh, pl: tuple, shape) -> DTensor:
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=stride)


@dataclasses.dataclass
class Moment:
    """One quantized moment tensor."""

    codes: torch.Tensor
    scale: torch.Tensor
    d: int

    def value(self) -> torch.Tensor:
        if not isinstance(self.codes, DTensor):
            return _dequantize(self.codes, self.scale, self.d)
        mesh, pl = self.codes.device_mesh, _rows(self.codes)
        x = _dequantize(self.codes.redistribute(mesh, pl).to_local(),
                        self.scale.redistribute(mesh, pl).to_local(), self.d)
        return _from_rows(x, mesh, pl, self.codes.shape[:-1] + (self.d,))

    @classmethod
    def of(cls, x: torch.Tensor, like: "Moment" = None) -> "Moment":
        """``x`` quantized; a DTensor's codes and scales are placed as
        ``like``'s (default: as ``x`` with its last dim gathered)."""
        if not isinstance(x, DTensor):
            codes, scale = _quantize(x)
            return cls(codes, scale, x.shape[-1])
        mesh = x.device_mesh
        pl = _rows(like.codes if like is not None else x)
        codes, scale = _quantize(x.redistribute(mesh, pl).to_local())
        lead = x.shape[:-1]
        codes = _from_rows(codes, mesh, pl, lead + (codes.shape[-1],))
        scale = _from_rows(scale, mesh, pl, lead + (scale.shape[-1],))
        if like is not None:
            codes, scale = placed_as(codes, like.codes), \
                placed_as(scale, like.scale)
        return cls(codes, scale, x.shape[-1])


def _zeros_like_moment(p: torch.Tensor, quantize: bool):
    zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if quantize and p.ndim >= 1 and p.shape[-1] >= _BLOCK:
        return Moment.of(zeros)
    return zeros


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    q = cfg.state_dtype == "int8"
    device = next(iter(params.values())).device
    return {
        "m": {k: _zeros_like_moment(v, q) for k, v in params.items()},
        "v": {k: _zeros_like_moment(v, q) for k, v in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _as_value(x):
    return x.value() if isinstance(x, Moment) else x


def _like(old, new_val: torch.Tensor):
    if isinstance(old, Moment):
        return Moment.of(new_val, old)
    return placed_as(new_val, old)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32;
    ``tree`` is a dict of tensors or a list of them."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    sums = [x.to(torch.float32).square().sum() for x in leaves]
    return torch.stack(sums).sum().sqrt()


def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    new_params, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        # the reference's expressions, each temporary written in place
        # once this function made it (see the module docstring):
        # m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
        # upd = (m / bc1) / (sqrt(v / bc2) + eps) [+ wd p],
        # p' = p - lr upd
        old_m, old_v = state["m"][k], state["v"][k]
        g = grads[k].to(torch.float32, copy=True).mul_(scale)
        m = _as_value(old_m)
        m = m.mul_(b1) if isinstance(old_m, Moment) else m * b1
        m.add_(g * (1 - b1))
        v = _as_value(old_v)
        v = v.mul_(b2) if isinstance(old_v, Moment) else v * b2
        v.add_(g.square_().mul_(1 - b2))
        del g
        new_m[k] = _like(old_m, m)
        upd = m / bc1
        del m
        new_v[k] = _like(old_v, v)
        upd.div_((v / bc2).sqrt_().add_(cfg.eps))
        del v
        p32 = p.to(torch.float32, copy=True)
        if p.ndim >= 2:  # decay matrices only (norms/biases exempt)
            upd.add_(p32 * cfg.weight_decay)
        new_params[k] = placed_as(p32.sub_(upd.mul_(lr)).to(p.dtype), p)
        del upd, p32

    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
