"""Chunk assignment across processes (port of
flutpu/parallel/multihost.py).

Chunk encode needs zero collectives, so the multi-process layout is
simple: each process encodes the chunks its devices own and stitches its
own outputs; one process (or the caller) concatenates the per-process
bitstreams in chunk order. ``ChunkAssignment`` and ``stitch_order`` are
copies of flutpu's; ``initialize`` and ``assignment`` read
``torch.distributed`` where flutpu reads ``jax.distributed``. Nothing on
a machine tells a program of its cluster: the caller gives the address,
the world size and the rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: str = "nccl") -> None:
    """``torch.distributed`` bootstrap (``init_method`` such as
    ``tcp://localhost:<port>``); a no-op in a single process or where the
    group already exists."""
    import torch.distributed as dist
    if world_size in (None, 1) and os.environ.get("WORLD_SIZE") in (None,
                                                                    "1"):
        return
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


@dataclass(frozen=True)
class ChunkAssignment:
    """Which GOP chunks of a batch this host owns."""
    process_id: int
    num_processes: int
    chunks_per_batch: int

    def local_chunks(self) -> List[int]:
        """Chunk indices whose devices live on this host (block layout:
        contiguous runs, matching jax's default device order so each
        chunk's data is produced where its chip is attached)."""
        per_host = self.chunks_per_batch // self.num_processes
        start = self.process_id * per_host
        return list(range(start, start + per_host))

    def owner_of(self, chunk: int) -> int:
        per_host = self.chunks_per_batch // self.num_processes
        return min(chunk // per_host, self.num_processes - 1)


def assignment(chunks_per_batch: Optional[int] = None) -> ChunkAssignment:
    """This process's share of a batch: rank and world size from
    ``torch.distributed`` (0 and 1 without a process group); chunks per
    batch default to one per visible CUDA device (at least one)."""
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    n_chunks = chunks_per_batch or max(1, torch.cuda.device_count())
    return ChunkAssignment(rank, world, n_chunks)


def stitch_order(per_host_payloads: Sequence[Tuple[int, bytes]]) -> bytes:
    """Gather step: concatenate (chunk_index, payload) pairs from all hosts
    in strict chunk order — the DCN-side analog of scenecollector's ordered
    drain."""
    return b"".join(p for _, p in sorted(per_host_payloads, key=lambda x: x[0]))
