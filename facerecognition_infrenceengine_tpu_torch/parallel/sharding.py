"""The device mesh, row shards and placement specs.

The torch form of ``facerecognition_infrenceengine_tpu/parallel/sharding.py``.
One process drives every device, as the reference's one JAX process drives
every device of ``jax.devices()``: a mesh is a 2-D array of
``torch.device``s, a sharded tensor is one row shard a device
(:class:`RowShards`), and a collective is an explicit device-to-device copy
(``Tensor.to``) followed by the merge step.  Autograd differentiates
through ``.to``, so a training step across devices needs no process group.

Mesh axes:
- ``data``    -- data parallelism over frames / queries / training images;
- ``gallery`` -- the gallery identity rows (and the ArcFace classifier's
  classes): each device of the axis holds a contiguous row shard.

A shard split along one axis lives at index 0 of the other: copies along
it would hold the same rows and compute the same thing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device

AXIS_DATA = "data"
AXIS_GALLERY = "gallery"


class Mesh:
    """A ``[data, gallery]`` grid of devices.

    ``devices`` is an object array of ``torch.device``; ``shape`` maps each
    axis name to its size (a dict, as JAX's ``Mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names=(AXIS_DATA, AXIS_GALLERY)):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def build_mesh(devices=None, data: int | None = None, gallery: int | None = None) -> Mesh:
    """A 2-D (data, gallery) mesh over ``devices``.

    Defaults: all gallery (``data=1``) -- the gallery is the axis that
    outgrows one device.  ``devices=None`` means every visible card, and
    raises when there is none.  A list may name one device more than once
    (``["cpu"] * 8``, ``["cuda:0"] * 8``): each shard is then a tensor of
    its own on that device, the counterpart of the virtual host devices
    XLA makes with ``--xla_force_host_platform_device_count``.
    """
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise RuntimeError("no CUDA device is visible; pass devices=[...] "
                               "(a CPU mesh: ['cpu'] * n)")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if gallery is None:
        gallery = n // (data or 1)
    if data is None:
        data = n // gallery if gallery else 0
    if data * gallery != n or n == 0:
        raise ValueError(f"mesh {data}x{gallery} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(data, gallery))


class RowShards:
    """A tensor's rows split over devices: ``parts[i]`` holds rows
    ``offsets[i]:offsets[i + 1]`` on its own device.  Immutable by use:
    nothing writes into a part in place."""

    def __init__(self, parts):
        self.parts = list(parts)
        if not self.parts:
            raise ValueError("no shards")
        sizes = [int(p.shape[0]) for p in self.parts]
        self.offsets = [int(x) for x in np.concatenate([[0], np.cumsum(sizes)])]

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.offsets[-1],) + tuple(self.parts[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device, where merged results land."""
        return self.parts[0].device

    @property
    def devices(self) -> list:
        return [p.device for p in self.parts]

    def __len__(self) -> int:
        return len(self.parts)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first shard's by default)."""
        device = self.device if device is None else device
        return torch.cat([p.to(device) for p in self.parts])

    def to(self, device) -> "RowShards":
        """Every shard moved to ``device`` (the shards stay apart)."""
        return RowShards([p.to(device) for p in self.parts])


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on a mesh, the counterpart of a
    ``NamedSharding``: dim 0 split over ``axis``, or whole (``axis=None``)
    on each device at index 0 of the gallery axis."""

    mesh: Mesh
    axis: str | None

    @property
    def devices(self) -> list:
        """The devices that hold a part: along ``axis`` at index 0 of the
        other axis; for a replicated tensor, the first device of each data
        row (once each)."""
        grid = self.mesh.devices
        if self.axis == AXIS_GALLERY:
            return list(grid[0, :])
        if self.axis == AXIS_DATA:
            return list(grid[:, 0])
        return list(dict.fromkeys(grid[:, 0]))

    def put(self, x):
        """``x`` (a tensor or an array) placed: :class:`RowShards` split as
        ``torch.tensor_split`` splits (sizes differ by at most one), or for
        a replicated placement a list of whole copies, one a device."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        devices = self.devices
        if self.axis is None:
            return [x.to(d) for d in devices]
        return RowShards(p.to(d) for p, d in zip(torch.tensor_split(x, len(devices)), devices))


def gallery_sharding(mesh: Mesh) -> Placement:
    """The [N, D] gallery matrix (and the classifier W): rows over the
    gallery axis."""
    return Placement(mesh, AXIS_GALLERY)


def batch_sharding(mesh: Mesh, ndim: int = 4) -> Placement:
    """A batch of frames / queries: the leading dim over the data axis,
    whatever the batch's rank ``ndim`` (the reference's argument)."""
    return Placement(mesh, AXIS_DATA)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)
