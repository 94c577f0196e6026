"""Vector clock baseline (paper §1.2): the exact O(N) structure the
bloom clock replaces, with the same functional surface."""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["VectorClock", "zeros", "tick", "merge", "compare"]


@dataclasses.dataclass(frozen=True)
class VectorClock:
    """vec: int32[..., n_nodes]."""

    vec: torch.Tensor

    @property
    def n(self) -> int:
        return self.vec.shape[-1]

    def sum(self) -> torch.Tensor:
        return self.vec.sum(-1)


def zeros(n_nodes: int, batch_shape: tuple = (), dtype=torch.int32,
          device=None) -> VectorClock:
    return VectorClock(torch.zeros(tuple(batch_shape) + (n_nodes,),
                                   dtype=dtype, device=device))


def tick(c: VectorClock, node_id) -> VectorClock:
    """§1.2 step 2: increment own slot."""
    node_id = torch.as_tensor(node_id, device=c.vec.device)
    one_hot = torch.nn.functional.one_hot(node_id, c.n).to(c.vec.dtype)
    return VectorClock(c.vec + one_hot)


def merge(a: VectorClock, b: VectorClock) -> VectorClock:
    """§1.2 step 3 (without the local tick): element-wise max."""
    return VectorClock(torch.maximum(a.vec, b.vec))


@dataclasses.dataclass(frozen=True)
class VCOrdering:
    a_le_b: torch.Tensor
    b_le_a: torch.Tensor
    concurrent: torch.Tensor
    equal: torch.Tensor


def compare(a: VectorClock, b: VectorClock) -> VCOrdering:
    a_le_b = (a.vec <= b.vec).all(-1)
    b_le_a = (b.vec <= a.vec).all(-1)
    return VCOrdering(a_le_b=a_le_b, b_le_a=b_le_a,
                      concurrent=~(a_le_b | b_le_a), equal=a_le_b & b_le_a)


def wire_bytes(n_nodes: int, counter_bytes: int = 4) -> int:
    """Message size of a vector clock (§2: O(N))."""
    return n_nodes * counter_bytes
