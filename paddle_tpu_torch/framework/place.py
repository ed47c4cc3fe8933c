"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/framework/place.py``.  JAX picks the chip
through PJRT; here every entry point (``GPTModel``, ``Generator``,
``Server``) takes an explicit ``device`` that defaults to CUDA.  A
missing card is an error, never a silent run on the host: the CPU is
used only when the caller asks for it (``device="cpu"``, as the tests
do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .enforce import PreconditionNotMetError

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a visible card
    raises :class:`PreconditionNotMetError`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise PreconditionNotMetError(
                "CUDA is not available: paddle_tpu_torch runs on the GPU "
                "unless the caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise PreconditionNotMetError(
            f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


class CPUPlace:
    """paddle.CPUPlace parity: the host."""

    def __init__(self):
        self.device = torch.device("cpu")


class CUDAPlace:
    """paddle.CUDAPlace parity: card ``id``."""

    def __init__(self, id=0):
        self.device = torch.device("cuda", int(id))


def place_device(place=None) -> torch.device:
    """The device of a Paddle place: ``None`` (CUDA), a
    :class:`CPUPlace`/:class:`CUDAPlace`, a ``torch.device`` or a string
    (``"cpu"``, ``"cuda"``, ``"gpu"``, ``"gpu:1"``)."""
    place = getattr(place, "device", place)
    if isinstance(place, str) and place.startswith("gpu"):
        place = "cuda" + place[3:]
    return resolve_device(place)


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    """The device of a module's first parameter, else of its first buffer
    (None if it has neither)."""
    for p in module.parameters():
        return p.device
    for b in module.buffers():
        return b.device
    return None
