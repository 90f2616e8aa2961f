"""The port's chunk encode split over two real processes
(``tests/torch_multihost_worker.py``): each joins a gloo group through
``multihost.initialize``, encodes the chunks ``multihost.assignment``
gives its rank in one dispatch, and the parent stitches their payloads.
The stitched stream equals one process encoding the same 8 chunks at
the same chunks per dispatch, and flutpu's ``FvcEncoder`` chunk by chunk
(flutpu's two-process test, ``test_multihost.py``, in the port)."""

import numpy as np
import torch

from flutpu.codec.fvc import FvcEncoder as JFvcEncoder
from flutpu_torch.parallel.multihost import ChunkAssignment, stitch_order

import torch_multihost_worker as worker

torch.set_num_threads(1)


def test_two_process_gloo_encode_stitches_bit_exact():
    pieces = worker.run_processes("cpu", timeout=120)
    assert sorted(pieces) == list(range(worker.CHUNKS))
    stitched = stitch_order(list(pieces.items()))
    frames = worker.batch()
    enc = worker.encoder("cpu", motion=False)
    halves = [ChunkAssignment(p, 2, worker.CHUNKS).local_chunks()
              for p in range(2)]
    single = b"".join(b"".join(enc.encode_chunks_finalize(
        enc.encode_chunks_dispatch(frames[half]))) for half in halves)
    assert stitched == single
    flutpu = b"".join(JFvcEncoder(quality=85).encode_chunk(frames[c])
                      for c in range(worker.CHUNKS))
    assert stitched == flutpu
