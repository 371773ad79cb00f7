"""The device mesh of the port's sharded paths.

The JAX package's ``jax.sharding.Mesh`` is an array of devices with named
axes; its corpus-sharded serving splits the moment index's rows over the
"corpus" axis and drives every device from one process (``shard_map``).
The port keeps that single-controller model: ``Mesh`` holds an array of
``torch.device``s and its axis names, a sharded operand is a list of
per-shard tensors (shard i on the i-th device of the axis, holding global
rows ``[i * n_loc, (i + 1) * n_loc)``: JAX's ``P(axis)`` layout), and a
shard body is a Python loop that queues each shard's work on its device
(``parallel/sharding.py``).

A mesh may repeat a device.  The tests run ``[cpu] * n`` meshes, as the
JAX package's tests run its virtual CPU devices, and a one-card machine
runs ``[cuda:0] * n``: every shard's kernels and products at their shard
shape, the merge and its tie order, on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """Devices in an array of ``len(axis_names)`` dimensions, one per named
    axis.  Frozen, and compared by identity, as ``serve_follow`` compares
    a live arena's mesh with its own."""

    devices: np.ndarray              # object array of torch.device
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis): shard
        i of an operand split over ``axis`` lives on the i-th."""
        a = self.axis_names.index(axis)
        line = np.moveaxis(self.devices, a, 0).reshape(
            self.devices.shape[a], -1)[:, 0]
        return list(line)


def make_mesh(
    axis_names: Sequence[str] = ("corpus",),
    shape: Optional[Tuple[int, ...]] = None,
    devices=None,
) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device; raises
    without CUDA, the port's rule of ``device.resolve_device``).  ``shape``
    defaults to all devices on the first axis; a shape that needs more
    devices than given raises ``ValueError``.  ``devices`` may repeat a
    device (see the module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes the visible CUDA devices by default and no "
                "CUDA device is available; pass devices= (e.g. "
                "[torch.device('cpu')] * n) to build a mesh elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), tuple(axis_names))
