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
the scan decoder ``flu_jpeg_decode_scan``, the segment-layout host
compaction ``flu_compact_segments_finalize``, and the entries that
``flutpu.native`` binds for the port's copies of ``fluc`` and ``io``: the
mutex, monitor and barrier (``flu_mutex_*``, ``flu_monitor_*``,
``flu_barrier_*``), the bandwidth meter and its per-connection variant
(``flu_bwmeter_*``) and the downloader (``flu_dl_*``, with the callback
types ``DATA_CB`` and ``DONE_CB``). ``get_lib()`` returns None where the
library cannot be built (no C++ toolchain) or when ``FLUTPU_NO_NATIVE``
is set; callers then take their numpy or pure-Python versions.
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


# Python-side callback ABI for the downloader (flutpu.native's)
DATA_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.c_void_p, ctypes.c_void_p)
DONE_CB = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_int))


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
    # fluc primitives
    for name in ("flu_mutex_new", "flu_monitor_new"):
        getattr(lib, name).restype = c.c_void_p
    lib.flu_barrier_new.restype = c.c_void_p
    lib.flu_barrier_new.argtypes = [c.c_int]
    for name in ("flu_mutex_lock", "flu_mutex_unlock", "flu_mutex_free",
                 "flu_monitor_lock", "flu_monitor_unlock", "flu_monitor_wait",
                 "flu_monitor_signal", "flu_monitor_broadcast",
                 "flu_monitor_free", "flu_barrier_pass", "flu_barrier_free"):
        getattr(lib, name).argtypes = [c.c_void_p]
    lib.flu_mutex_trylock.argtypes = [c.c_void_p]
    lib.flu_mutex_trylock.restype = c.c_int
    lib.flu_monitor_wait_ms.argtypes = [c.c_void_p, c.c_long]
    lib.flu_monitor_wait_ms.restype = c.c_int
    lib.flu_barrier_set_open.argtypes = [c.c_void_p, c.c_int]
    lib.flu_barrier_is_open.argtypes = [c.c_void_p]
    lib.flu_barrier_is_open.restype = c.c_int
    lib.flu_barrier_trypass_ms.argtypes = [c.c_void_p, c.c_long]
    lib.flu_barrier_trypass_ms.restype = c.c_int
    # bwmeter
    lib.flu_bwmeter_data.argtypes = [c.c_uint64]
    lib.flu_bwmeter_get.argtypes = [c.POINTER(c.c_double),
                                    c.POINTER(c.c_double),
                                    c.POINTER(c.c_uint64)]
    # bwmeter sock variant (per-connection instance meters); hasattr-gated
    # in bwmeter.py so a stale .so degrades to the Python meter
    if hasattr(lib, "flu_bwmeter_sock_new"):
        lib.flu_bwmeter_sock_new.restype = c.c_void_p
        for name in ("flu_bwmeter_sock_free", "flu_bwmeter_sock_start",
                     "flu_bwmeter_sock_end"):
            getattr(lib, name).argtypes = [c.c_void_p]
        lib.flu_bwmeter_sock_data.argtypes = [c.c_void_p, c.c_uint64]
        lib.flu_bwmeter_sock_get.argtypes = [c.c_void_p,
                                             c.POINTER(c.c_double),
                                             c.POINTER(c.c_double),
                                             c.POINTER(c.c_uint64)]
    # downloader
    lib.flu_dl_new.restype = c.c_void_p
    lib.flu_dl_new.argtypes = [DATA_CB, DONE_CB]
    lib.flu_dl_destroy.argtypes = [c.c_void_p]
    lib.flu_dl_new_task.restype = c.c_void_p
    lib.flu_dl_new_task.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                    c.c_void_p]
    lib.flu_dl_abort_task.argtypes = [c.c_void_p]
    lib.flu_dl_abort_all.argtypes = [c.c_void_p, c.c_int]
    lib.flu_dl_pause.argtypes = [c.c_void_p]
    lib.flu_dl_resume.argtypes = [c.c_void_p]
    lib.flu_dl_task_get_url.restype = c.c_char_p
    lib.flu_dl_task_get_url.argtypes = [c.c_void_p]
    lib.flu_dl_task_get_length.restype = c.c_size_t
    lib.flu_dl_task_get_length.argtypes = [c.c_void_p]
    lib.flu_dl_task_get_http_status.restype = c.c_int
    lib.flu_dl_task_get_http_status.argtypes = [c.c_void_p]
    lib.flu_dl_task_get_date.restype = c.c_char_p
    lib.flu_dl_task_get_date.argtypes = [c.c_void_p]
    lib.flu_dl_task_get_header.restype = c.c_char_p
    lib.flu_dl_task_get_header.argtypes = [c.c_void_p]
    lib.flu_dl_task_get_outcome.restype = c.c_int
    lib.flu_dl_task_get_outcome.argtypes = [c.c_void_p]
    lib.flu_dl_task_set_outcome.argtypes = [c.c_void_p, c.c_int]
    lib.flu_dl_outcome_string.restype = c.c_char_p
    lib.flu_dl_outcome_string.argtypes = [c.c_int]
    lib.flu_dl_set_polling_period.argtypes = [c.c_void_p, c.c_long]
    lib.flu_dl_get_polling_period.restype = c.c_long
    lib.flu_dl_get_polling_period.argtypes = [c.c_void_p]
    lib.flu_dl_set_timeouts.argtypes = [c.c_void_p, c.c_long, c.c_long]
    lib.flu_dl_set_user_agent.argtypes = [c.c_void_p, c.c_char_p]
    lib.flu_dl_set_cookies.argtypes = [c.c_void_p, c.c_char_p]
    lib.flu_dl_set_proxy.argtypes = [c.c_void_p, c.c_char_p]
    lib.flu_dl_set_ssl.argtypes = [c.c_void_p, c.c_int, c.c_char_p]
    lib.flu_dl_ssl_available.restype = c.c_int
    lib.flu_dl_task_get_ssl_status.restype = c.c_int
    lib.flu_dl_task_get_ssl_status.argtypes = [c.c_void_p]
    lib.flu_dl_get_tasks_count.restype = c.c_int
    lib.flu_dl_get_tasks_count.argtypes = [c.c_void_p]
    # reference-parity surface (fludownloader.h:94-185); hasattr-gated:
    # these landed in round 4, and a stale pre-round-4 .so (no make
    # toolchain to rebuild) must degrade per the module contract, not
    # AttributeError out of the first get_lib() caller
    if hasattr(lib, "flu_dl_lock"):
        lib.flu_dl_lock.argtypes = [c.c_void_p]
        lib.flu_dl_unlock.argtypes = [c.c_void_p]
        lib.flu_dl_task_get_abort.restype = c.c_int
        lib.flu_dl_task_get_abort.argtypes = [c.c_void_p]
        lib.flu_dl_ssl_status_string.restype = c.c_char_p
        lib.flu_dl_ssl_status_string.argtypes = [c.c_int]
        lib.flu_dl_getdate.restype = c.c_longlong
        lib.flu_dl_getdate.argtypes = [c.c_char_p]
