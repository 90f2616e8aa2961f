"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and are compiled by ``nvcc`` for
Hopper (``sm_90a``), one nvcc per source side by side, and linked into
one shared library that ``ctypes`` loads: no PyTorch headers, so a build
takes seconds. The library lands in ``flutpu_torch/_build/`` under a
name that carries a hash of the sources, the header they include and the
flags, so it is built at first use and rebuilt whenever one of them
changes. Nothing here runs at import time: the CPU-only test runs import
every module of the package without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("frontend.cu", "entropy_pack.cu", "motion.cu", "transform.cu")
HEADERS = ("device.cuh",)  # included by the sources: part of the hash
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def source_paths() -> List[str]:
    return [os.path.join(CSRC_DIR, s) for s in SOURCES]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_paths() + [os.path.join(CSRC_DIR, n) for n in HEADERS]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libflutpu_torch_{source_hash()}.so")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def compile_commands(obj_dir: str, nvcc: Optional[str] = None):
    """One nvcc command per source, each to its own object in
    ``obj_dir``: [(command, object path)]."""
    nvcc = nvcc or find_nvcc()
    out = []
    for src in source_paths():
        obj = os.path.join(obj_dir, os.path.basename(src) + ".o")
        out.append(([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], obj))
    return out


def link_command(out_path: str, objects: List[str],
                 nvcc: Optional[str] = None) -> List[str]:
    return [nvcc or find_nvcc(), "-shared", "-o", out_path, *objects]


def build(out_path: Optional[str] = None) -> str:
    """Compile the sources into ``out_path`` (default: library_path()):
    every source by its own nvcc, all started together, then one link.
    The compilers' messages (``-Xptxas=-v``: registers, shared memory and
    spills per kernel) land in ``out_path + ".log"``. Concurrent builds
    serialize on a lock file; the library appears atomically."""
    out_path = out_path or library_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(out_path):
            return out_path
        tmp = f"{out_path}.tmp{os.getpid()}"
        obj_dir = tmp + ".d"
        os.makedirs(obj_dir, exist_ok=True)
        try:
            jobs = [(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     cmd[-1]) for cmd, _ in compile_commands(obj_dir)]
            log, failed = [], []
            for proc, src in jobs:
                text, _ = proc.communicate(timeout=600)
                log.append(f"== {os.path.basename(src)}\n{text}")
                if proc.returncode != 0:
                    failed.append(f"{src} ({proc.returncode})")
            if failed:
                raise RuntimeError("nvcc failed: " + ", ".join(failed)
                                   + "\n" + "\n".join(log))
            objs = [obj for _, obj in compile_commands(obj_dir)]
            res = subprocess.run(link_command(tmp, objs), capture_output=True,
                                 text=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                                   f"{res.stderr}")
            with open(out_path + ".log", "w") as fh:
                fh.write("\n".join(log))
            os.replace(tmp, out_path)
        finally:
            shutil.rmtree(obj_dir, ignore_errors=True)
    return out_path


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flu_front_end_init.argtypes = [p, p, p]
    lib.flu_front_end_init.restype = i
    lib.flu_front_end.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p, i, i,
                                  p]
    lib.flu_front_end.restype = i
    lib.flu_front_end_quotient_check.argtypes = [p, p]
    lib.flu_front_end_quotient_check.restype = i
    lib.flu_pack_init.argtypes = [p, p]
    lib.flu_pack_init.restype = i
    lib.flu_pack_segments.argtypes = [p, p, p, p, i, i, i, p]
    lib.flu_pack_segments.restype = i
    lib.flu_pack_blocks.argtypes = [p, p, p, p, i, p]
    lib.flu_pack_blocks.restype = i
    lib.flu_pack_slots64.argtypes = [p, p, p, p, p, i, i, p]
    lib.flu_pack_slots64.restype = i
    lib.flu_pack_slots32.argtypes = [p, p, p, p, i, i, p]
    lib.flu_pack_slots32.restype = i
    # the motion entries take nc planes of (h, w) one after the other
    lib.flu_motion_search_mc.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.flu_motion_search_mc.restype = i
    lib.flu_motion_search_mc_blocks.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.flu_motion_search_mc_blocks.restype = i
    lib.flu_motion_search_hier.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.flu_motion_search_hier.restype = i
    lib.flu_chroma_mc.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.flu_chroma_mc.restype = i
    # the in-loop transform: n planes of (h, w) and the device DCT matrix
    lib.flu_block_dct.argtypes = [p, p, p, i, i, i, p]
    lib.flu_block_dct.restype = i
    lib.flu_block_idct.argtypes = [p, p, p, i, i, i, p]
    lib.flu_block_idct.restype = i


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            lib = ctypes.CDLL(path)
            _configure(lib)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


_count_lock = threading.Lock()


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper``'s launch count. Several streaming threads
    (one per encoder branch of a hype bin) launch kernels at once; the
    lock keeps their counts from overwriting each other."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
