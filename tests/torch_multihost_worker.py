"""Worker process of the port's two-process chunk encode (the counterpart
of ``_multihost_worker.py``).

Each process joins a ``torch.distributed`` group over gloo, takes the
chunks its rank owns (``multihost.assignment``), encodes them in one
dispatch with the port's ``FvcEncoder`` on its device, and prints
``CHUNK <index> <payload hex>`` lines, then ``WORKER_OK``. The gather is
the parent collecting stdout: nothing but the bitstreams crosses
processes (the zero-collective encode contract); one ``all_reduce`` of
the chunk counts shows the group is real.

Usage: python torch_multihost_worker.py <init_method> <world_size> <rank>
       <device> [--motion] [--size HxW]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the batch every process builds: 8 chunks of 2 frames, seed 7
CHUNKS, FRAMES, SEED = 8, 2, 7


def batch(h: int = 32, w: int = 32):
    import numpy as np
    rng = np.random.default_rng(SEED)   # the same batch in every process
    return rng.integers(0, 256, (CHUNKS, FRAMES, h, w, 3), np.uint8)


def encoder(device: str, motion: bool):
    from flutpu_torch.codec.fvc import FvcEncoder
    return FvcEncoder(quality=85, motion=motion, device=device)


def run_processes(device: str, *args: str, world: int = 2,
                  timeout: float = 120.0):
    """Start ``world`` workers of this file on ``device`` over a gloo group
    on a free localhost port; → {chunk index: payload} from their output.
    Every worker must exit 0 and print WORKER_OK; all are stopped on a
    failure or at ``timeout`` seconds."""
    import socket
    import subprocess
    import tempfile
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, os.path.abspath(__file__),
           f"tcp://127.0.0.1:{port}", str(world)]
    pieces = {}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(os.path.join(tmp, f"{k}.out"), "w+"),
                 open(os.path.join(tmp, f"{k}.err"), "w+"))
                for k in range(world)]
        procs = [subprocess.Popen(cmd + [str(k), device, *args],
                                  stdout=out, stderr=err, text=True)
                 for k, (out, err) in enumerate(logs)]
        try:
            for p, (out, err) in zip(procs, logs):
                p.wait(timeout=timeout)
                out.seek(0)
                err.seek(0)
                text = out.read()
                if p.returncode != 0 or "WORKER_OK" not in text:
                    raise RuntimeError(f"worker failed ({p.returncode}): "
                                       f"{err.read()[-2000:]}")
                for line in text.splitlines():
                    if line.startswith("CHUNK "):
                        _, ci, payload = line.split(" ", 2)
                        pieces[int(ci)] = bytes.fromhex(payload)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for out, err in logs:
                out.close()
                err.close()
    return pieces


def main() -> None:
    init_method, world, rank, device = (sys.argv[1], int(sys.argv[2]),
                                        int(sys.argv[3]), sys.argv[4])
    motion = "--motion" in sys.argv
    h = w = 32
    if "--size" in sys.argv:
        h, w = map(int, sys.argv[sys.argv.index("--size") + 1].split("x"))
    import torch
    import torch.distributed as dist
    from flutpu_torch.parallel import multihost

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False   # FVC motion's in-loop DCT
    multihost.initialize(init_method=init_method, world_size=world,
                         rank=rank, backend="gloo")
    assert dist.get_rank() == rank and dist.get_world_size() == world
    a = multihost.assignment(chunks_per_batch=CHUNKS)
    local = a.local_chunks()
    n = torch.tensor([len(local)])
    dist.all_reduce(n)
    assert int(n) == CHUNKS, int(n)
    enc = encoder(device, motion)
    payloads = enc.encode_chunks_finalize(
        enc.encode_chunks_dispatch(batch(h, w)[local]))
    for ci, payload in zip(local, payloads):
        print(f"CHUNK {ci} {payload.hex()}", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
