"""Device layout of the chunk axis (port of flutpu/parallel/mesh.py).

flutpu expresses GOP-chunk data parallelism as a ``jax.sharding.Mesh``
with a ``chunk`` axis (one or more GOP chunks per chip) and an optional
``spatial`` axis (rows of a frame across chips). Chunk independence
(forced keyframes at chunk starts) means the encode needs no collectives.

Here a ``ChunkMesh`` is the list of torch devices on the ``chunk`` axis.
On one device the chunk axis is a batch axis: the C chunks of a dispatch
all lie on that device and every kernel takes them in one launch (flutpu's
one-device mesh hands its whole C axis to one shard, which ``vmap``s it).
A tensor's device says where it lives, so flutpu's ``chunk_sharding``
has no counterpart. Placing chunks on several cards (a process per card
over ``torch.distributed``) and the ``spatial`` axis are not ported yet:
ROADMAP queue 1, item 5.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class ChunkMesh:
    """The devices of the ``chunk`` axis, in order."""

    axis_names = ("chunk",)

    def __init__(self, devices: Sequence):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a chunk mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = devices

    @property
    def size(self) -> int:
        return len(self.devices)

    def single_device(self) -> torch.device:
        """The one device of a one-device mesh; raises for more (chunks on
        several cards are not ported yet)."""
        if len(self.devices) != 1:
            raise NotImplementedError(
                f"a chunk mesh of {len(self.devices)} devices: placing "
                "chunks on several cards (a process per card over "
                "torch.distributed) is not ported yet (ROADMAP queue 1, "
                "item 5)")
        return self.devices[0]

    def __repr__(self) -> str:
        return f"ChunkMesh({[str(d) for d in self.devices]})"


def visible_devices() -> Tuple[torch.device, ...]:
    """Every CUDA device torch sees, in index order."""
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


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
                            devices: Optional[Sequence] = None):
    """flutpu's 2-D mesh (GOP chunks x frame-row stripes): not ported."""
    raise NotImplementedError(
        "spatial striping (row stripes with halo exchange, FVC header "
        "flags bit 4) is not ported yet (ROADMAP queue 1, item 5)")
