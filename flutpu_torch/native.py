"""The port's loader of the repository's C++ runtime library (``native/``).

The port's own counterpart of ``flutpu.native``: it compiles the same
sources (``native/bitstream``, ``native/fluc``, ``native/downloader``)
with the Makefile's flags, one compiler per source side by side, links
them with ``-lz`` into ``flutpu_torch/_build/`` under a name that carries
a hash of the sources and flags, and loads the library with ``ctypes``.
It builds at first use and again whenever a source changes; nothing runs
at import time. The Makefile itself writes into the JAX package's
directory, so it is not used here.

Bound entries: the baseline-JPEG scan coder ``flu_jpeg_encode_scan``,
the scan decoder ``flu_jpeg_decode_scan`` and the segment-layout host
compaction ``flu_compact_segments_finalize``. ``get_lib()`` returns None
where the library cannot be built (no C++ toolchain) or when
``FLUTPU_NO_NATIVE`` is set; callers then take their numpy versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

from ._build import BUILD_DIR

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
SOURCE_DIRS = ("bitstream", "fluc", "downloader")
#: the Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread")
LD_FLAGS = ("-shared", "-pthread")
LIBS = ("-lz",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def source_paths() -> List[str]:
    return [p for d in SOURCE_DIRS
            for p in sorted(glob.glob(os.path.join(NATIVE_DIR, d, "*.cpp")))]


def source_hash() -> str:
    """Hash of the flags, the sources and the headers beside them."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS + LIBS).encode())
    for d in SOURCE_DIRS:
        for path in sorted(glob.glob(os.path.join(NATIVE_DIR, d, "*.[ch]pp"))):
            h.update(os.path.relpath(path, NATIVE_DIR).encode())
            with open(path, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libflutpu_native_{source_hash()}.so")


def _cxx() -> str:
    return os.environ.get("CXX") or shutil.which("g++") or "c++"


def compile_commands(obj_dir: str, cxx: Optional[str] = None):
    """One compiler command per source, each to its own object in
    ``obj_dir``: [(command, object path)]."""
    cxx = cxx or _cxx()
    out = []
    for src in source_paths():
        rel = os.path.relpath(src, NATIVE_DIR).replace(os.sep, "_")
        obj = os.path.join(obj_dir, rel + ".o")
        out.append(([cxx, *CXX_FLAGS, "-c", "-o", obj, src], obj))
    return out


def link_command(out_path: str, objects: List[str],
                 cxx: Optional[str] = None) -> List[str]:
    return [cxx or _cxx(), *LD_FLAGS, "-o", out_path, *objects, *LIBS]


def build(out_path: Optional[str] = None) -> str:
    """Compile every source by its own compiler, all started together,
    then link. Concurrent builds serialize on a lock file; the library
    appears atomically. Raises on a compiler or linker error."""
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
            cmds = compile_commands(obj_dir)
            jobs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                    for cmd, _ in cmds]
            failed = []
            for proc, (cmd, _) in zip(jobs, cmds):
                text, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text}")
            if failed:
                raise RuntimeError("native build failed: " + "\n".join(failed))
            res = subprocess.run(link_command(tmp, [o for _, o in cmds]),
                                 capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"native link failed ({res.returncode}):\n"
                                   f"{res.stderr}")
            os.replace(tmp, out_path)
        finally:
            shutil.rmtree(obj_dir, ignore_errors=True)
    return out_path


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built first if this source hash has none; None
    where it cannot be built or loaded, or when ``FLUTPU_NO_NATIVE`` is
    set."""
    global _lib, _tried
    if os.environ.get("FLUTPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        try:
            if not os.path.exists(path):
                build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        _configure(lib)
        _lib = lib
        return _lib


def _configure(lib) -> None:
    c = ctypes
    i16p = c.POINTER(c.c_int16)
    u32p = c.POINTER(c.c_uint32)
    u8p = c.POINTER(c.c_uint8)
    lib.flu_jpeg_encode_scan.restype = c.c_long
    lib.flu_jpeg_encode_scan.argtypes = [
        i16p, c.c_int, c.c_int,
        i16p, i16p, c.c_int, c.c_int,
        c.c_int, c.c_int,
        u32p, u8p, u32p, u8p, u32p, u8p, u32p, u8p,
        u8p, c.c_long,
    ]
    lib.flu_compact_segments_finalize.restype = c.c_long
    lib.flu_compact_segments_finalize.argtypes = [
        u32p, c.c_long, u32p, c.c_long, c.c_int, u8p, c.c_long,
    ]
    lib.flu_jpeg_decode_scan.restype = c.c_long
    lib.flu_jpeg_decode_scan.argtypes = [
        u8p, c.c_long, c.c_int,
        i16p, c.c_int, c.c_int,
        i16p, i16p, c.c_int, c.c_int,
        c.c_int, c.c_int,
        u8p, u8p, c.c_int, u8p, u8p, c.c_int,
        u8p, u8p, c.c_int, u8p, u8p, c.c_int,
    ]
