"""Device policy of the port: entry points run on CUDA unless the caller
names another device. There is no silent CPU fallback — a run that
asked for nothing on a host without a card raises, so a number taken
on the CPU can never pass for a device number."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA and raises
    when no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph
    (False on a host without CUDA)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def resolve_generator(device: torch.device, generator=None):
    """The generator that draws parameters on ``device``: ``generator``,
    which must live there, or one on ``device`` seeded with 0."""
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot "
                         f"initialize parameters on {device}")
    return generator
