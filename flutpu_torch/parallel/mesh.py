"""Device layout of the chunk and spatial axes (port of
flutpu/parallel/mesh.py).

flutpu expresses GOP-chunk data parallelism as a ``jax.sharding.Mesh``
with a ``chunk`` axis (one or more GOP chunks per chip) and an optional
``spatial`` axis (rows of a frame across chips). Chunk independence
(forced keyframes at chunk starts) means the encode needs no collectives
in the chunk direction.

Here a mesh is a list of shard devices:

- ``ChunkMesh``: the devices of the ``chunk`` axis, in order. C chunks
  split into contiguous blocks of C / M over its M shards, and each
  shard's block is a batch axis on its device (every kernel takes the
  block's chunks in one launch; flutpu's shard ``vmap``s its block).
- ``ChunkSpatialMesh``: a (chunk, spatial) grid. Each chunk shard also
  cuts every frame of its block into ``spatial`` row stripes, stripe s on
  the grid's device (m, s); motion rows cross stripes as halos.

A device may repeat: several shards on one card, or on the CPU, stand
in for several cards (flutpu's tests do the same with virtual CPU
devices). A tensor's device says where it lives, so flutpu's
``chunk_sharding`` has no counterpart. ``deal_devices`` places a mesh's
slots round the visible cards.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class ChunkMesh:
    """The devices of the ``chunk`` axis, in order (a device may repeat)."""

    axis_names = ("chunk",)

    def __init__(self, devices: Sequence):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a chunk mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = devices

    @property
    def size(self) -> int:
        """M, the shards of the chunk axis."""
        return len(self.devices)

    @property
    def spatial(self) -> int:
        return 1

    def shards(self) -> Tuple[Tuple[torch.device, ...], ...]:
        """Per chunk shard, its stripes' devices (one stripe here)."""
        return tuple((d,) for d in self.devices)

    def single_device(self) -> torch.device:
        """The one device every shard lies on; ValueError where the shards
        span several devices."""
        devs = set(d for shard in self.shards() for d in shard)
        if len(devs) != 1:
            raise ValueError(f"{self!r} spans {len(devs)} devices, not one")
        return self.devices[0]

    def __repr__(self) -> str:
        return f"ChunkMesh({[str(d) for d in self.devices]})"


class ChunkSpatialMesh(ChunkMesh):
    """A (chunk, spatial) grid of shard devices: ``chunk`` shards on the
    chunk axis, each cutting its frames into ``spatial`` row stripes. The
    first chunk x spatial of ``devices`` fill the grid row by row, as
    flutpu reshapes its device list."""

    axis_names = ("chunk", "spatial")

    def __init__(self, chunk: int, spatial: int, devices: Sequence):
        devices = tuple(torch.device(d) for d in devices)
        n = chunk * spatial
        if chunk < 1 or spatial < 1:
            raise ValueError(f"mesh axes must be >= 1, got ({chunk}, "
                             f"{spatial})")
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        self.grid: Tuple[Tuple[torch.device, ...], ...] = tuple(
            devices[m * spatial:(m + 1) * spatial] for m in range(chunk))
        super().__init__([row[0] for row in self.grid])
        self._spatial = spatial

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.grid), self._spatial)

    @property
    def spatial(self) -> int:
        return self._spatial

    def shards(self) -> Tuple[Tuple[torch.device, ...], ...]:
        return self.grid

    def __repr__(self) -> str:
        return (f"ChunkSpatialMesh({self.shape}, "
                f"{[[str(d) for d in row] for row in self.grid]})")


def visible_devices() -> Tuple[torch.device, ...]:
    """Every CUDA device torch sees, in index order."""
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def deal_devices(n_slots: int, devices: Optional[Sequence] = None
                 ) -> Tuple[torch.device, ...]:
    """``n_slots`` mesh slots dealt round ``devices`` (default: the
    visible cards) in order: slot k goes to device k mod n."""
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no device to deal the mesh's slots to")
    return tuple(devices[k % len(devices)] for k in range(n_slots))


def make_chunk_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> ChunkMesh:
    """1-D mesh over the ``chunk`` axis: the first ``n_devices`` of
    ``devices`` (default: every visible CUDA device)."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    return ChunkMesh(devices)


def make_chunk_spatial_mesh(chunk: int, spatial: int,
                            devices: Optional[Sequence] = None
                            ) -> ChunkSpatialMesh:
    """2-D mesh: GOP chunks x frame-row stripes over the first chunk x
    spatial of ``devices`` (default: every visible CUDA device); fewer
    raise ValueError, as flutpu's does."""
    if devices is None:
        devices = visible_devices()
    return ChunkSpatialMesh(chunk, spatial, list(devices))
