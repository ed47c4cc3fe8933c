"""The device mesh: named axes over an array of devices.

Counterpart of ``paddle_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` over the chips PJRT finds; the port's :class:`Mesh`
is a small class of its own that holds an array of ``torch.device``s,
the axis names and a ``{name: size}`` shape.  It needs no process group
(``torch.distributed``'s ``DeviceMesh`` does), because this slice runs on
one card: a layer or ``TrainStep`` given a mesh whose axes all have size
1 runs on that mesh's one device, and a mesh over more devices is refused
where it would need collectives (ROADMAP A11, A12).

Axes, as in the JAX package: ``dp`` data parallel, ``mp`` tensor
parallel, ``pp`` pipeline, ``sp`` sequence, ``ep`` expert parallel (MoE).
``make_mesh`` keeps JAX's rule that drops an axis of size 1 other than
``dp``, so ``make_mesh({"ep": 1})`` on one card is ``{"dp": 1}``.  The
default devices are the visible CUDA devices; without a card the caller
passes ``devices=[torch.device("cpu")]`` (the tests do).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..framework.enforce import PreconditionNotMetError
from ..framework.place import resolve_device

__all__ = ["DP_AXIS", "MP_AXIS", "PP_AXIS", "SP_AXIS", "EP_AXIS", "Mesh",
           "make_mesh", "init_mesh", "get_mesh", "has_mesh",
           "mesh_axis_size", "MeshGuard"]

DP_AXIS = "dp"
MP_AXIS = "mp"
PP_AXIS = "pp"
SP_AXIS = "sp"
EP_AXIS = "ep"

_AXIS_ORDER = (DP_AXIS, EP_AXIS, PP_AXIS, MP_AXIS, SP_AXIS)

_current_mesh: Optional["Mesh"] = None


class Mesh:
    """``devices``: an array of ``torch.device`` shaped by the axes;
    ``axis_names``: one name per array axis; ``shape``: ``{name:
    size}`` in axis order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} axes needs as many "
                             f"names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def _default_devices():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise PreconditionNotMetError(
            "CUDA is not available: a mesh is built over the CUDA devices "
            "unless the caller passes devices=[torch.device('cpu')]")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None
              ) -> Mesh:
    """A mesh from ``{axis: size}``.  Sizes must multiply to the device
    count (one size of -1 is inferred).  Axes of size 1 other than
    ``dp`` are dropped, and a mesh left with no axis is ``{"dp": n}``.
    Axis order: dp, ep, pp, mp, sp, then any other name."""
    devices = [resolve_device(d) for d in devices] \
        if devices is not None else _default_devices()
    n = len(devices)
    axes = {k: v for k, v in axes.items() if v != 1 or k == DP_AXIS}
    if not axes:
        axes = {DP_AXIS: n}
    names = [a for a in _AXIS_ORDER if a in axes] + \
            [a for a in axes if a not in _AXIS_ORDER]
    sizes = [axes[a] for a in names]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} need {total} "
                         f"devices, have {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), names)


def init_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Install the process-global mesh; by default data parallel over
    every device."""
    global _current_mesh
    _current_mesh = make_mesh(axes or {DP_AXIS: -1}, devices)
    return _current_mesh


def get_mesh() -> Mesh:
    """The global mesh, installed on first use as ``{"dp": n}`` over the
    CUDA devices."""
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = make_mesh({DP_AXIS: -1})
    return _current_mesh


def has_mesh() -> bool:
    return _current_mesh is not None


def mesh_axis_size(axis: str) -> int:
    return get_mesh().shape.get(axis, 1)


def single_device(mesh: Mesh) -> Optional[torch.device]:
    """The one device of a mesh whose axes all have size 1, else None."""
    return mesh.devices.flat[0] if mesh.size == 1 else None


@contextlib.contextmanager
def MeshGuard(mesh: Mesh):
    """Swap the global mesh for the duration of the block."""
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev
