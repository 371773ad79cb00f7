"""The device mesh of the port's sharded paths.

The JAX package's ``jax.sharding.Mesh`` is an array of devices with named
axes: corpus-sharded serving splits the moment index's rows over a
"corpus" axis, data-parallel training splits each batch over a "data" axis
(and its mining refresh splits the index over the same axis), and one
process drives every device.  The port keeps that single-controller model:
``Mesh`` holds an array of ``torch.device``s and its axis names, a sharded
operand is a list of per-shard tensors (shard i on the i-th device of the
axis, holding global rows ``[i * n_loc, (i + 1) * n_loc)``: JAX's
``P(axis)`` layout; ``split_batch`` for batches), and a shard body is a
Python loop that queues each shard's work on its device
(``parallel/sharding.py``, ``train/step.py``).  Merges, the training loss
and the optimizer update run once, on the axis's ``lead`` device.

A mesh may repeat a device.  The tests run ``[cpu] * n`` meshes, as the
JAX package's tests run its virtual CPU devices, and a one-card machine
runs ``[cuda:0] * n``: every shard's kernels and products at their shard
shape, the merge and its tie order, on one card.  Copies made per position
(``replicate``) stay distinct tensors on a repeated device, so reductions
and broadcasts run there as they would across cards; read-only state is
placed once per ``distinct`` device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vfr_tpu_torch.utils.tree import tree_map


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

    def lead(self, axis: str) -> torch.device:
        """The first device of ``axis``: where a sharded computation's merge,
        loss and update run."""
        return self.axis_devices(axis)[0]


def distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    """``devices`` without repeats, in order of first appearance."""
    return list(dict.fromkeys(devices))


def replicate(tree, devices: Sequence[torch.device]) -> List:
    """One copy of ``tree`` (a nested dict of tensors) per position of
    ``devices``: distinct tensors even where a device repeats."""
    return [tree_map(lambda t, d=d: t.to(d, copy=True), tree)
            for d in devices]


def split_batch(batch: Dict, devices: Sequence[torch.device], axis: int = 0,
                copy: Optional[Callable] = None) -> List[Dict]:
    """One dict per position of ``devices``: each value's i-th of
    ``len(devices)`` equal slices along ``axis`` (JAX's ``P(axis)``), placed
    on ``devices[i]`` by ``copy(slice, device)`` (default: as a tensor, with
    ``.to``).  Values are numpy arrays or tensors; a size along ``axis``
    that is not a multiple of the device count raises ``ValueError``."""
    if copy is None:
        def copy(v, d):
            return torch.as_tensor(v).to(d)
    n = len(devices)
    out = [{} for _ in devices]
    for key, v in batch.items():
        size = v.shape[axis]
        if size % n:
            raise ValueError(
                f"batch key {key!r} has {size} rows along axis {axis}, not a "
                f"multiple of the {n} devices it is split over")
        b = size // n
        lead = (slice(None),) * axis
        for i, (o, d) in enumerate(zip(out, devices)):
            o[key] = copy(v[lead + (slice(i * b, (i + 1) * b),)], d)
    return out


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
