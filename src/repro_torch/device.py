"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["indexed_device", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without a CUDA device that is an error:
    an entry point never falls back to the CPU on its own; callers that
    want the CPU (the tests, the plain reference run) ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def indexed_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that it compares equal to the device of a tensor placed there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
