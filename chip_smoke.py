#!/usr/bin/env python3
"""Smoke run of flutpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Drives the port's main paths through the entry points a user calls, at
1080p (coded 1088x1920), quality 85, 4:2:0:

1. build: compiles the CUDA kernels from ``flutpu_torch/csrc`` with nvcc
   (one nvcc per source, all started together);
2. JPEG kernels: on one 16-frame GOP, the front-end kernel (K1) against
   its plain PyTorch version (equal except ±1 on rounding ties, on at
   most 1e-4 of the coefficients) and the Huffman pack kernel (K2)
   against its plain version (bit-identical), each timed with CUDA
   events;
2b. block-pack kernels (the non-segment layout): on the 16-frame GOP's
   MCU blocks (K1's coefficients through ``_mcu_blocks``), K7, K8a (on
   ``_slot_tables_merged``) and K8b (on ``_slot_tables``) each
   bit-identical to its plain version and the three to each other, each
   timed beside its byte bound;
3. JPEG main path: ``JpegEncoder.encode_gop_dispatch_src`` on the
   on-device gradient-ball source, 8 GOPs with two in flight, then the
   pipeline ``videotestsrc ! cudajpegenc ! appsink`` over 32 frames;
4. JPEG checks: every frame's scan decodes (native
   ``flu_jpeg_decode_scan``) to exactly K1's coefficients, equals the
   native ``flu_jpeg_encode_scan`` of those coefficients byte for byte,
   and reconstructs at >= 30 dB PSNR against its source;
4b. the non-segment JPEG path: ``JpegEncoder(segmented=False)``, 8 GOPs
   of the same source with two in flight (K1 and K7 launched, K2 not),
   checked as in phase 4 and byte-identical to phase 3's GOPs, frames/s
   beside phase 3's, and both layouts' device busy time per GOP
   (torch.profiler); one GOP under ``FLUTPU_NO_FUSED_PACK=1`` (K8a
   launched, same bytes); the pipeline ``videotestsrc ! cudajpegenc
   segmented=false ! appsink`` over 32 frames, byte-identical to phase
   3's pipeline;
5. motion kernels: the search kernel (K3) against its plain version on
   three 1080p luma pairs (consecutive gradient-ball frames, a rolled
   plane plus noise, an in-loop reconstruction as reference): the
   prediction equals the compensation of the kernel's vectors exactly,
   and the vectors equal the plain version's except at near-ties of the
   cost, each verified in float64; the chroma kernel (K4) bit-identical
   to its plain version at search ranges 7 and 5; both timed;
5b. hier and block-size kernels: K6a (the search kernel's 8x8 instance
   on the three pairs pooled to 544x960 at r=3, its 16x16 instance at
   r=7), K5 (pool, K6a, base clip and the refine kernel at r=7) and K6b
   (K3's contract) against their plain versions, held as K3 is; each
   timed, K5 also its refine kernel alone;
6. FVC main paths: ``FvcEncoder(motion=True).encode_chunk_dispatch_src``,
   6 chunks of 8 frames with two in flight (K2, K3, K4 launched), then
   2 chunks of FVC v1 (K1, K2), then the pipeline
   ``videotestsrc ! cudafvcenc motion=true ! appsink`` over 16 frames;
7. FVC checks: every chunk decodes through the port's ``FvcDecoder`` on
   the card at >= 30 dB, every payload's scan equals the native
   ``flu_jpeg_encode_scan`` of its decoded coefficients, and the CPU
   decode (plain PyTorch) of each path's first chunk lies within 0.05 dB
   of the card's;
8. FVC hier+B main path: ``FvcEncoder(motion=True, hier=True,
   bframes=1)``, 6 chunks of 8 frames with two in flight (K5, K6a, K4,
   K2 launched), then one chunk each of its neighbours (``bframes=1``
   with the full search through K3: BASELINE config 6b; P-only hier;
   P-only with ``FLUTPU_SEARCH_DYGRID=1`` through K6b), all decoded and
   checked as in phase 7 with B frames (type 2) where expected, and a
   544x960 hier+B chunk encoded on the card and on the CPU: byte-identical
   (else held to the tie contract: same frame types, within 0.05 dB);
9. FVC without segments: one chunk each of v1, v2 P-only and hier+B with
   ``segmented=False`` (K7 launched, K2 not), each byte-identical to the
   segmented chunk of the same source (the first chunk of phases 6 and 8)
   and checked as in phase 7.

Each main path runs with every kernel's launch count set to 0 just
before it and read just after; a kernel of the path that was not
launched fails the run. Prints each phase's wall time, the card's name
and power limit, one JSON
line of per-kernel results (each kernel's launches, error, time, plain
time, and its bound: the larger of its bytes over 3.35 TB/s and its
floating-point operations over 67 TFLOP/s, the H100 SXM data sheet's
HBM and fp32 rates), and as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits nonzero. It exits nonzero without a result where there is
no CUDA device or no flutpu_torch. It imports nothing of jax or of the
JAX package ``flutpu``: the port carries its own dataflow core and
native-library loader.

Usage: ``python3 chip_smoke.py`` from the repository root (one GPU).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

H, W = 1080, 1920          # frame size
PH, PW = 1088, 1920        # coded size (multiples of 16)
GOP = 16                   # frames per dispatch
N_GOPS = 8                 # GOPs on the timed main path
PIPE_FRAMES = 32
QUALITY = 85
MIN_PSNR = 30.0
MAX_TIE_SHARE = 1e-4
CHUNK = 8                  # FVC frames per chunk
N_CHUNKS = 6               # FVC motion chunks on the timed main path
N_V1_CHUNKS = 2
FVC_PIPE_FRAMES = 16
SEARCH_RANGE = 7
MAX_DPSNR = 0.05           # card vs CPU decode of one stream, dB
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at its 700 W limit
FP32_OPS_PER_S = 67e12     # the same, fp32 outside the tensor cores
_T_START = time.perf_counter()


def _bound(n_bytes: float, fp32_ops: float = 0.0) -> dict:
    """The least time the card could take for work that moves ``n_bytes``
    (each input read once, each output written once) and does
    ``fp32_ops`` float operations. Integer work has no rate in the data
    sheet's table and is not counted."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


class _Laps:
    """Wall seconds of each phase, from the end of the one before."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.secs = {}

    def __call__(self, name: str) -> None:
        t = time.perf_counter()
        self.secs[name] = round(t - self.t0, 2)
        self.t0 = t
        print(f"phase {name}: {self.secs[name]:.2f} s", flush=True)


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def _require(ok, msg) -> None:
    """A check of the run (kept under ``python -O``, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls after one warm call.
    The calls queue behind a device-side sleep, so a kernel's time is not
    its wrapper's host cost where the launch queue holds all the calls
    (one launch each); a plain version's thousands of launches still
    pace with the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e6 + reps * 4e5, 2e8)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _native_scan(lib, y, cb, cr) -> bytes:
    """flu_jpeg_encode_scan of one frame's (BH, BW, 64) int16 planes."""
    import numpy as np
    from flutpu_torch.codec import jpeg_tables as T
    c = ctypes
    arrs = T.code_arrays()
    y, cb, cr = (np.ascontiguousarray(a, np.int16) for a in (y, cb, cr))
    cap = y.nbytes + cb.nbytes + cr.nbytes + (1 << 16)
    out = np.empty(cap, np.uint8)
    i16p = lambda a: a.ctypes.data_as(c.POINTER(c.c_int16))  # noqa: E731
    tabs = []
    for name in ("dc_luma", "ac_luma", "dc_chroma", "ac_chroma"):
        codes = np.ascontiguousarray(arrs[name][0])
        lens = np.ascontiguousarray(arrs[name][1])
        tabs += [codes.ctypes.data_as(c.POINTER(c.c_uint32)),
                 lens.ctypes.data_as(c.POINTER(c.c_uint8))]
    n = lib.flu_jpeg_encode_scan(
        i16p(y), y.shape[1], y.shape[0], i16p(cb), i16p(cr), cb.shape[1],
        cb.shape[0], 1, 3, *tabs, out.ctypes.data_as(c.POINTER(c.c_uint8)),
        cap)
    _require(n >= 0, f"flu_jpeg_encode_scan failed ({n})")
    return out[:n].tobytes()


def _check_frames(lib, payloads, coefs, sources, enc, label):
    """Every payload against the kernel's coefficients and its source.
    coefs: (y, cb, cr) device int16 of the GOP; sources: (F, H, W, 3)
    uint8 device frames. Returns the lowest PSNR."""
    import numpy as np
    import torch
    from flutpu_torch.codec.decode import (coefs_to_rgb, decode_scan_to_coefs,
                                           parse_jfif)
    y, cb, cr = (c.cpu().numpy() for c in coefs)
    _require(len(payloads) == y.shape[0], (label, len(payloads)))
    for i, data in enumerate(payloads):
        info = parse_jfif(data)
        _require(info is not None and (info["h"], info["w"]) == (H, W),
                 f"{label} frame {i}: JFIF headers")
        dec = decode_scan_to_coefs(info["scan"], PW // 8, PH // 8, PW // 16,
                                   PH // 16, True)
        _require(dec is not None, f"{label} frame {i}: scan does not decode")
        for a, b_, name in zip(dec, (y[i], cb[i], cr[i]), "y cb cr".split()):
            _require(np.array_equal(a, b_), f"{label} frame {i}: decoded "
                     f"{name} differs from the kernel's coefficients")
        _require(info["scan"] == _native_scan(lib, y[i], cb[i], cr[i]),
                 f"{label} frame {i}: scan differs from flu_jpeg_encode_scan")
    rgb = coefs_to_rgb(*coefs, enc._qy_dev, enc._qc_dev, H, W)
    mse = ((rgb.float() - sources.float()) ** 2).mean(dim=(1, 2, 3))
    psnr = (10 * torch.log10(255.0 ** 2 / mse.clamp(min=1e-12))).cpu()
    _require(bool((psnr >= MIN_PSNR).all()),
             f"{label}: PSNR {float(psnr.min()):.2f} dB")
    return float(psnr.min())


def main() -> int:
    try:
        import numpy  # noqa: F401
        import torch
    except ImportError as e:
        return _fail(f"needs torch and numpy ({e})")
    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is false)")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import flutpu_torch  # noqa: F401  (registers cudajpegenc)
    except ImportError as e:
        return _fail(f"flutpu_torch is not importable here ({e})")
    if "flutpu" in sys.modules:
        return _fail("flutpu_torch imported the JAX package flutpu")

    print(_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = run(torch.device("cuda", 0))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev):
    """Every phase on ``dev``; returns the per-kernel records. Raises on
    any failed check."""
    import numpy as np
    import torch
    from flutpu_torch import _build, native
    from flutpu_torch.codec.jpeg import JpegEncoder
    from flutpu_torch.codec.ops import entropy_kernels as K
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.codec.ops.entropy import mcu_layout, segment_blocks
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    from flutpu_torch.core import parse_launch

    # -- 1. build -----------------------------------------------------------
    lap = _Laps()
    t0 = time.perf_counter()
    lib = native.get_lib()
    _require(lib is not None, "the native library (native/ sources) did "
             "not build")
    print(f"native build: {time.perf_counter() - t0:.2f} s "
          f"({os.path.basename(native.library_path())})", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({os.path.basename(_build.library_path())})", flush=True)
    lap("1 build")

    # -- 2. kernels against their plain versions ---------------------------
    enc = JpegEncoder(quality=QUALITY, device=dev)
    qy, qc = enc._qy_dev, enc._qc_dev
    layout = mcu_layout(PW // 8, PH // 8, PW // 16, PH // 16, True)
    results = {}

    def k1_compare(planes, label):
        got = F.front_end(*planes, qy, qc)
        want = F.front_end_plain(*planes, qy, qc)
        n = diff = 0
        worst = 0
        for a, b in zip(got, want):
            d = (a.to(torch.int32) - b.to(torch.int32)).abs()
            worst = max(worst, int(d.max()))
            diff += int((d > 0).sum())
            n += d.numel()
        share = diff / n
        print(f"front_end vs plain ({label}): {diff} of {n} coefficients "
              f"differ (share {share:.3e}), max |diff| {worst}", flush=True)
        _require(worst <= 1 and share <= MAX_TIE_SHARE,
                 f"front_end vs plain ({label}): max {worst}, share {share}")
        return got, worst

    src = gradient_ball_planes(PH, PW, GOP, 0, device=dev)
    coefs0, err_src = k1_compare(src, "gradient-ball GOP")
    rng = np.random.default_rng(0)
    noise = tuple(torch.from_numpy(rng.integers(0, 256, (GOP, PH, PW),
                                                np.uint8)).to(dev)
                  for _ in range(3))
    _, err_noise = k1_compare(noise, "uniform-noise GOP")
    del noise
    k1_ms = _time_ms(lambda: F.front_end(*src, qy, qc), 20)
    k1_plain_ms = _time_ms(lambda: F.front_end_plain(*src, qy, qc), 5)
    print(f"front_end: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms "
          "per 16-frame 1080p GOP", flush=True)
    # u8 RGB in, int16 Y + Cb + Cr out; per pixel ~17 flops of colour
    # conversion and 1.5 samples of 8x8 DCT (2 x 8 multiply-adds per
    # dimension: 32 flops) and quantization (~3 flops)
    px = GOP * PH * PW
    results["front_end"] = dict(max_abs_err=max(err_src, err_noise),
                                ms=k1_ms, plain_ms=k1_plain_ms,
                                **_bound(3 * px + 2 * 1.5 * px,
                                         px * (17 + 1.5 * 35)))

    zz, comp_f = segment_blocks(*coefs0, layout)
    k2_err = 0
    for sw in (JpegEncoder.SEG_WORDS0, 8):
        buf, bits = K.pack_segments(zz, comp_f, 16, sw)
        pbuf, pbits = K.pack_segments_plain(zz, comp_f, 16, sw)
        over = int((pbits > sw * 32).sum())
        same = torch.equal(buf, pbuf) and torch.equal(bits, pbits)
        print(f"pack_segments vs plain (seg_words={sw}, {bits.numel()} "
              f"segments, {over} over capacity): "
              f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
        _require(same, f"pack_segments differs from its plain version at "
                 f"seg_words={sw}")
        k2_err = max(k2_err, int((buf.to(torch.int64)
                                  - pbuf.to(torch.int64)).abs().max()))
    sw = JpegEncoder.SEG_WORDS0
    k2_ms = _time_ms(lambda: K.pack_segments(zz, comp_f, 16, sw), 20)
    k2_plain_ms = _time_ms(lambda: K.pack_segments_plain(zz, comp_f, 16, sw),
                           3)
    print(f"pack_segments: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms "
          f"per 16-frame 1080p GOP ({zz.shape[0]} blocks)", flush=True)
    s_count = zz.shape[0] // 16
    results["pack_segments"] = dict(
        max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
        **_bound(zz.shape[0] * (64 + 1) * 4 + s_count * (sw + 1) * 4))
    del zz, comp_f, buf, pbuf
    lap("2 K1, K2")
    results.update(run_block_packs(coefs0, layout))
    del coefs0, src
    torch.cuda.synchronize()
    lap("2b K7, K8a, K8b")

    # -- 3. the main path ---------------------------------------------------
    def source(ph, pw, start):
        return gradient_ball_planes(ph, pw, GOP, start, device=dev)

    # one GOP first so the adaptive sizes are learned, as a stream would
    enc.encode_gop_finalize(enc.encode_gop_dispatch_src(source, 0, H, W,
                                                        PH, PW))
    torch.cuda.synchronize()
    F.front_end.launches = 0
    K.pack_segments.launches = 0

    payloads, dev_ms, wall = _in_flight(
        lambda gi: enc.encode_gop_dispatch_src(source, gi * GOP, H, W, PH,
                                               PW),
        enc.encode_gop_finalize, N_GOPS)
    fps = N_GOPS * GOP / wall
    frame_bytes = np.mean([len(p) for v in payloads for p in v])
    print(f"main path: {N_GOPS} GOPs x {GOP} frames in {wall:.3f} s = "
          f"{fps:.1f} frames/s; device span {dev_ms:.3f} ms per GOP "
          f"(CUDA events); seg_words {enc._seg_words}, prefix window "
          f"{enc._prefix_window}; mean {frame_bytes:.0f} bytes/frame",
          flush=True)

    bufs, pipe_wall = _pipeline(
        parse_launch, f"videotestsrc num-buffers={PIPE_FRAMES} "
        f"pattern=gradient width={W} height={H} ! cudajpegenc "
        f"batch-frames={GOP} ! appsink name=out")
    launches = {"front_end": F.front_end.launches,
                "pack_segments": K.pack_segments.launches}
    print(f"pipeline: {len(bufs)} frames in {pipe_wall:.3f} s; kernel "
          f"launches on the main path {launches}", flush=True)
    _require(len(bufs) == PIPE_FRAMES, f"pipeline gave {len(bufs)} frames")
    _require([b.pts for b in bufs] == sorted(b.pts for b in bufs),
             "pipeline output out of order")
    for name, n in launches.items():
        _require(n > 0, f"{name} was not launched on the main path")
    lap("3 JPEG main path")

    # -- 4. checks ------------------------------------------------------------
    worst_psnr = float("inf")
    for gi in range(N_GOPS):
        planes = source(PH, PW, gi * GOP)
        coefs = F.front_end(*planes, qy, qc)
        frames = torch.stack(planes, dim=-1)[:, :H, :W]
        worst_psnr = min(worst_psnr, _check_frames(
            lib, payloads[gi], coefs, frames, enc, f"GOP {gi}"))
    from flutpu_torch.codec.jpeg import _edge_pad
    from flutpu_torch.core.elements import make_test_frame
    for g0 in range(0, PIPE_FRAMES, GOP):
        frames = torch.from_numpy(np.stack([
            make_test_frame("gradient", W, H, i)
            for i in range(g0, g0 + GOP)])).to(dev)
        planes = [_edge_pad(frames[..., c], PH, PW) for c in range(3)]
        coefs = F.front_end(*planes, qy, qc)
        worst_psnr = min(worst_psnr, _check_frames(
            lib, [b.data for b in bufs[g0:g0 + GOP]], coefs, frames, enc,
            f"pipeline frames {g0}-{g0 + GOP - 1}"))
    print(f"checks: {N_GOPS * GOP + PIPE_FRAMES} frames decode to the "
          f"kernel's coefficients, match flu_jpeg_encode_scan byte for "
          f"byte; lowest PSNR {worst_psnr:.2f} dB", flush=True)
    lap("4 JPEG checks")

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    add(run_jpeg_blocks(dev, lib, enc, payloads, fps,
                        [bytes(b.data) for b in bufs]))
    lap("4b non-segment JPEG")
    results.update(run_motion_kernels(dev))
    lap("5 K3, K4")
    results.update(run_hier_kernels(dev))
    lap("5b K5, K6a, K6b")
    counts, seg_chunks = run_fvc(dev, lib)
    add(counts)
    lap("6-7 FVC")
    counts, seg_chunks["hier+B"] = run_fvc_hier_b(dev, lib)
    add(counts)
    lap("8 FVC hier+B")
    add(run_fvc_blocks(dev, lib, seg_chunks))
    lap("9 FVC non-segment")
    print(f"phase wall times (s): {json.dumps(lap.secs)}; "
          f"{time.perf_counter() - _T_START:.2f} s since the script started",
          flush=True)

    kernels = [
        dict(name="front_end", route="cuda",
             source="flutpu_torch/csrc/frontend.cu",
             replaces="flutpu/codec/ops/frontend_pallas.py:179",
             launches=launches["front_end"], **results["front_end"]),
        dict(name="pack_segments", route="cuda",
             source="flutpu_torch/csrc/entropy_pack.cu",
             replaces="flutpu/codec/ops/entropy_pallas.py:439",
             launches=launches["pack_segments"], **results["pack_segments"]),
        dict(name="motion_search_mc", route="cuda",
             source="flutpu_torch/csrc/motion.cu",
             replaces="flutpu/codec/ops/motion_pallas.py:288",
             launches=launches["motion_search_mc"],
             **results["motion_search_mc"]),
        dict(name="chroma_mc", route="cuda",
             source="flutpu_torch/csrc/motion.cu",
             replaces="flutpu/codec/ops/motion_pallas.py:771",
             launches=launches["chroma_mc"], **results["chroma_mc"]),
        dict(name="motion_search_mc_hier", route="cuda",
             source="flutpu_torch/csrc/motion.cu",
             replaces="flutpu/codec/ops/motion_pallas.py:444",
             launches=launches["motion_search_mc_hier"],
             **results["motion_search_mc_hier"]),
        dict(name="motion_search_mc_blocks", route="cuda",
             source="flutpu_torch/csrc/motion.cu",
             replaces="flutpu/codec/ops/motion_pallas.py:122",
             launches=launches["motion_search_mc_blocks"],
             **results["motion_search_mc_blocks"]),
        dict(name="motion_search_mc_dygrid", route="cuda",
             source="flutpu_torch/csrc/motion.cu",
             replaces="flutpu/codec/ops/motion_pallas.py:615",
             launches=launches["motion_search_mc_dygrid"],
             **results["motion_search_mc_dygrid"]),
        dict(name="pack_block_bits_fused", route="cuda",
             source="flutpu_torch/csrc/entropy_pack.cu",
             replaces="flutpu/codec/ops/entropy_pallas.py:245",
             launches=launches["pack_block_bits_fused"],
             **results["pack_block_bits_fused"]),
        dict(name="pack_block_bits64", route="cuda",
             source="flutpu_torch/csrc/entropy_pack.cu",
             replaces="flutpu/codec/ops/entropy_pallas.py:493",
             launches=launches["pack_block_bits64"],
             **results["pack_block_bits64"]),
        dict(name="pack_block_bits", route="cuda",
             source="flutpu_torch/csrc/entropy_pack.cu",
             replaces="flutpu/codec/ops/entropy_pallas.py:541",
             launches=launches["pack_block_bits"],
             **results["pack_block_bits"]),
    ]
    for k in kernels:
        k.setdefault("library_ms", None)   # no single torch call computes any
    jax_side = sorted(m for m in sys.modules if m in ("jax", "flutpu")
                      or m.startswith(("jax.", "flutpu.")))
    _require(not jax_side, f"imported from the JAX side: {jax_side}")
    return kernels


def _in_flight(dispatch, finalize, n: int):
    """``n`` dispatches (``dispatch(i)`` → handle) with two in flight, each
    finalized in order → (outputs, mean device span per dispatch in ms
    (CUDA events around the dispatch: the host's enqueue where the host
    sets the pace), wall seconds)."""
    import torch
    outs, spans, pending = {}, [], []

    def drain():
        i, hnd, a, b = pending.pop(0)
        outs[i] = finalize(hnd)
        b.synchronize()
        spans.append(a.elapsed_time(b))

    t0 = time.perf_counter()
    for i in range(n):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        handle = dispatch(i)
        ev1.record()
        pending.append((i, handle, ev0, ev1))
        if len(pending) == 2:
            drain()
    while pending:
        drain()
    return ([outs[i] for i in range(n)], sum(spans) / len(spans),
            time.perf_counter() - t0)


def _device_busy(fn, n: int):
    """Run ``fn`` (``n`` dispatches' work) under torch.profiler → (device
    busy ms per dispatch: the union of the traced device intervals,
    kernels and copies; the five largest kernels as (name, ms per
    dispatch, launches per dispatch)), or None where the profiler traced
    no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        t, c = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:5]
    return busy / 1e3 / n, [(k[:48], t / 1e3 / n, c / n)
                            for k, (t, c) in top]


def _pipeline(parse_launch, desc: str):
    """Play a launch string ending in ``appsink name=out`` and pull every
    buffer → (buffers, wall seconds)."""
    pipe = parse_launch(desc)
    sink = pipe.get_by_name("out")
    t0 = time.perf_counter()
    pipe.play()
    bufs = []
    try:
        while (buf := sink.try_pull_buffer(timeout=60)) is not None:
            bufs.append(buf)
    finally:
        pipe.stop()
    return bufs, time.perf_counter() - t0


def _near_tie_check(cur, prev, mv_k, mv_p, r, mb=16, bias=True):
    """Blocks (mb x mb) where the kernel's and the plain version's vectors
    differ must be near-ties: their costs (SAD * 64 + |dy| + |dx| with
    ``bias``, the plain SAD of the hier refine without), recomputed in
    float64, agree within the fp32 rounding of an mb*mb-term SAD. Returns
    the count."""
    import torch
    diff = (mv_k != mv_p).any(-1).nonzero().tolist()
    c64, p64 = cur.double(), prev.double()
    h, w = cur.shape
    scale = 64 if bias else 1
    for by, bx in diff:
        costs = []
        for v in (mv_k[by, bx], mv_p[by, bx]):
            dy, dx = int(v[0]), int(v[1])
            _require(max(abs(dy), abs(dx)) <= r, f"vector {v} out of range")
            rows = (torch.arange(mb, device=cur.device) + mb * by - dy) % h
            cols = (torch.arange(mb, device=cur.device) + mb * bx - dx) % w
            sad = (c64[mb * by:mb * by + mb, mb * bx:mb * bx + mb]
                   - p64[rows][:, cols]).abs().sum()
            costs.append((float(sad), float(sad) * scale
                          + (abs(dy) + abs(dx) if bias else 0)))
        (sad_k, cost_k), (sad_p, cost_p) = costs
        tol = scale * mb * mb * 2.0 ** -23 * max(sad_k, sad_p, 1.0)
        _require(abs(cost_k - cost_p) <= tol,
                 f"mb ({by}, {bx}): vectors {mv_k[by, bx].tolist()} vs "
                 f"{mv_p[by, bx].tolist()} are no near-tie (float64 costs "
                 f"{cost_k} vs {cost_p})")
    return len(diff)


def _motion_pairs(dev, rng):
    """Three 1088x1920 luma (label, cur, prev) pairs: consecutive
    gradient-ball frames, a rolled plane plus noise drawn from ``rng``,
    and an in-loop reconstruction (after an I frame) as the reference."""
    import numpy as np
    import torch
    from flutpu_torch.codec.fvc import _code_plane
    from flutpu_torch.codec.ops.colorspace import planes_to_i420
    from flutpu_torch.codec.ops.quant import LUMA_QTABLE, scale_qtable
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes

    y = planes_to_i420(*gradient_ball_planes(PH, PW, 2, 3, device=dev))[0]
    plane = torch.from_numpy(rng.uniform(0, 255, (PH, PW))
                             .astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.normal(0, 2, (PH, PW))
                             .astype(np.float32)).to(dev)
    qy = torch.from_numpy(scale_qtable(LUMA_QTABLE, QUALITY)).to(dev)
    # the loop's reference after an I frame: clip(128 + IDCT residual)
    rec = (128.0 + _code_plane(y[0] - 128.0, qy)[1]).clamp(0.0, 255.0)
    return [("gradient-ball frames 3->4", y[1], y[0]),
            ("rolled plane + noise", torch.roll(plane, (5, -3), (0, 1))
             + noise, plane),
            ("in-loop reference", y[1], rec)]


def run_block_packs(coefs, layout):
    """Phase 2b: K7, K8a and K8b on one GOP's MCU blocks against their
    plain versions and each other, and their times beside their bounds.
    K8a's and K8b's bytes follow the data (``data_bytes``), plus each
    block's 64 words and count out."""
    import torch
    from flutpu_torch.codec.ops import entropy_kernels as K
    from flutpu_torch.codec.ops.entropy import (_mcu_blocks, _slot_tables,
                                                _slot_tables_merged)
    mcu, comp = _mcu_blocks(*coefs, layout)
    zz = mcu.reshape(-1, 64)
    comp = comp.repeat(mcu.shape[0])
    n = zz.shape[0]
    merged = _slot_tables_merged(zz, comp)
    slots = _slot_tables(zz, comp)
    out_bytes = n * (K.BLOCK_WORDS + 1) * 4

    def data_bytes(lens):
        """4 bytes per length up to each block's last active slot, and 4
        per value word the kernel reads: lo where the length is not 0, hi
        too where it exceeds 32 (K8b's tables have no length above 32)."""
        pos = torch.arange(1, lens.shape[1] + 1, device=lens.device)
        last = torch.where(lens > 0, pos, 0).amax(dim=1)
        return 4 * (int(last.sum()) + int((lens > 0).sum())
                    + int((lens > 32).sum()))

    cases = {
        "pack_block_bits_fused": (K.pack_block_bits_fused,
                                  K.pack_block_bits_fused_plain, (zz, comp),
                                  n * (64 + 1) * 4),
        "pack_block_bits64": (K.pack_block_bits64, K.pack_block_bits64_plain,
                              merged, data_bytes(merged[0])),
        "pack_block_bits": (K.pack_block_bits, K.pack_block_bits_plain, slots,
                            data_bytes(slots[0])),
    }
    results, outs = {}, []
    for name, (kernel, plain, args, in_bytes) in cases.items():
        got, want = kernel(*args), plain(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"{name} vs plain ({n} blocks): "
              f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
        _require(same, f"{name} differs from its plain version")
        outs.append(got)
        ms = _time_ms(lambda: kernel(*args), 20)
        plain_ms = _time_ms(lambda: plain(*args), 3)
        bound = _bound(in_bytes + out_bytes)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms per "
              f"16-frame 1080p GOP; bound {bound['bound_ms']:.4f} ms "
              f"({(in_bytes + out_bytes) / 1e6:.1f} MB)", flush=True)
        results[name] = dict(max_abs_err=max(
            int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            for a, b in zip(got, want)), ms=ms, plain_ms=plain_ms, **bound)
    same = all(torch.equal(a, b) for o in outs[1:]
               for a, b in zip(o, outs[0]))
    print(f"K7, K8a, K8b against each other: "
          f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
    _require(same, "the three block packs disagree")
    torch.cuda.synchronize()
    return results


def run_jpeg_blocks(dev, lib, seg_enc, seg_payloads, seg_fps, seg_pipe):
    """Phase 4b: the non-segment JPEG path on the phase-3 GOPs, the K8a
    arm, and the element; every frame checked and byte-identical to the
    segment layout's; device busy time per GOP of both layouts (profiler).
    Returns the kernels' launch counts."""
    import torch
    from flutpu_torch.codec.jpeg import JpegEncoder
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    from flutpu_torch.core import parse_launch

    def source(ph, pw, start):
        return gradient_ball_planes(ph, pw, GOP, start, device=dev)

    enc = JpegEncoder(quality=QUALITY, segmented=False, device=dev)
    # one GOP first so the adaptive sizes are learned, as a stream would
    enc.encode_gop_finalize(enc.encode_gop_dispatch_src(source, 0, H, W,
                                                        PH, PW))
    (payloads, dev_ms, wall), n = _count_launches(lambda: _in_flight(
        lambda gi: enc.encode_gop_dispatch_src(source, gi * GOP, H, W, PH,
                                               PW),
        enc.encode_gop_finalize, N_GOPS))
    fps = N_GOPS * GOP / wall
    print(f"non-segment path: {N_GOPS} GOPs x {GOP} frames in {wall:.3f} s "
          f"= {fps:.1f} frames/s (segment path {seg_fps:.1f} in this run); "
          f"device span {dev_ms:.3f} ms per GOP (CUDA events); prefix "
          f"window {enc._prefix_window}; kernel launches {n}", flush=True)
    _require(n["front_end"] > 0 and n["pack_block_bits_fused"] > 0,
             "K1 and K7 must launch on the non-segment path")
    _require(n["pack_segments"] == 0 and n["pack_block_bits64"] == 0,
             "the non-segment path launched K2 or K8a")
    _require(payloads == seg_payloads,
             "non-segment GOPs differ from the segment layout's")
    worst = float("inf")
    for gi in range(N_GOPS):
        planes = source(PH, PW, gi * GOP)
        coefs = F.front_end(*planes, enc._qy_dev, enc._qc_dev)
        frames = torch.stack(planes, dim=-1)[:, :H, :W]
        worst = min(worst, _check_frames(lib, payloads[gi], coefs, frames,
                                         enc, f"non-segment GOP {gi}"))
    print(f"checks (non-segment): {N_GOPS * GOP} frames decode to K1's "
          f"coefficients, equal flu_jpeg_encode_scan and the segment "
          f"layout's bytes; lowest PSNR {worst:.2f} dB", flush=True)

    for label, e in (("segment", seg_enc), ("non-segment", enc)):
        t0 = time.perf_counter()
        got = _device_busy(lambda: _in_flight(
            lambda gi: e.encode_gop_dispatch_src(source, gi * GOP, H, W, PH,
                                                 PW),
            e.encode_gop_finalize, 4), 4)
        if got is None:
            print(f"device busy ({label}): not measured (the profiler "
                  "traced no device activity)", flush=True)
            continue
        busy, top = got
        print(f"device busy ({label} layout, torch.profiler, 4 GOPs, "
              f"{time.perf_counter() - t0:.2f} s with the trace): "
              f"{busy:.3f} ms per GOP; largest kernels per GOP: "
              + "; ".join(f"{k} {t:.3f} ms x{c:g}" for k, t, c in top),
              flush=True)

    os.environ["FLUTPU_NO_FUSED_PACK"] = "1"
    try:
        (one, _, wall), n64 = _count_launches(lambda: _in_flight(
            lambda gi: enc.encode_gop_dispatch_src(source, 0, H, W, PH, PW),
            enc.encode_gop_finalize, 1))
    finally:
        os.environ.pop("FLUTPU_NO_FUSED_PACK")
    print(f"FLUTPU_NO_FUSED_PACK=1: 1 GOP in {wall:.3f} s; kernel launches "
          f"{n64}", flush=True)
    _require(n64["pack_block_bits64"] > 0
             and n64["pack_block_bits_fused"] == 0,
             "K8a must launch (and K7 not) under FLUTPU_NO_FUSED_PACK=1")
    _require(one[0] == seg_payloads[0], "the K8a arm's GOP differs")

    (bufs, pipe_wall), n_pipe = _count_launches(lambda: _pipeline(
        parse_launch, f"videotestsrc num-buffers={PIPE_FRAMES} "
        f"pattern=gradient width={W} height={H} ! cudajpegenc "
        f"segmented=false batch-frames={GOP} ! appsink name=out"))
    print(f"pipeline (segmented=false): {len(bufs)} frames in "
          f"{pipe_wall:.3f} s; kernel launches {n_pipe}", flush=True)
    _require(n_pipe["pack_block_bits_fused"] > 0
             and n_pipe["pack_segments"] == 0,
             "cudajpegenc segmented=false did not run K7 alone")
    _require([bytes(b.data) for b in bufs] == seg_pipe,
             "cudajpegenc segmented=false differs from the segment layout")
    return {k: n[k] + n64[k] + n_pipe[k] for k in n}


def run_motion_kernels(dev):
    """Phase 5: K3 and K4 against their plain versions at 1080p."""
    import numpy as np
    import torch
    from flutpu_torch.codec.ops import motion_kernels as M

    r = SEARCH_RANGE
    rng = np.random.default_rng(1)
    pairs = _motion_pairs(dev, rng)
    err = 0.0
    for label, cur, prev in pairs:
        err = max(err, _hold_search(
            label, "motion_search_mc", M.motion_search_mc(cur, prev, r),
            M.motion_search_mc_plain(cur, prev, r), cur, prev, r, 16, True,
            lambda p, m: M.motion_compensate(p, m, r)))
    cur, prev = pairs[2][1], pairs[2][2]
    k3_ms = _time_ms(lambda: M.motion_search_mc(cur, prev, r), 20)
    k3_plain_ms = _time_ms(lambda: M.motion_search_mc_plain(cur, prev, r), 3)
    print(f"motion_search_mc: kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.3f} "
          f"ms per 1088x1920 luma frame (r={r})", flush=True)

    k4_err = 0.0
    for rr in (7, 5):
        cb, cr = (torch.from_numpy(rng.normal(128, 30, (PH // 2, PW // 2))
                                   .astype(np.float32)).to(dev)
                  for _ in range(2))
        mv = torch.from_numpy(rng.integers(-rr, rr + 1,
                                           (PH // 16, PW // 16, 2))
                              .astype(np.int32)).to(dev)
        got = M.chroma_mc(cb, cr, mv, rr)
        want = M.chroma_mc_plain(cb, cr, mv, rr)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"chroma_mc vs plain (r={rr}, random vectors): "
              f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
        _require(same, f"chroma_mc differs from its plain version at r={rr}")
        k4_err = max(k4_err, *(float((a - b).abs().max())
                               for a, b in zip(got, want)))
    k4_ms = _time_ms(lambda: M.chroma_mc(cb, cr, mv, rr), 50)
    k4_plain_ms = _time_ms(lambda: M.chroma_mc_plain(cb, cr, mv, rr), 10)
    print(f"chroma_mc: kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms per "
          "pair of 544x960 chroma planes", flush=True)
    torch.cuda.synchronize()
    return {"motion_search_mc": dict(max_abs_err=err, ms=k3_ms,
                                     plain_ms=k3_plain_ms,
                                     **_search_bound(PH, PW, 16, r)),
            "chroma_mc": dict(max_abs_err=k4_err, ms=k4_ms,
                              plain_ms=k4_plain_ms,
                              **_bound(4 * (PH // 2) * (PW // 2) * 4
                                       + (PH // 16) * (PW // 16) * 2 * 4))}


def _search_bound(h: int, w: int, mb: int, r: int, extra_ops: float = 0):
    """A search + compensation of one (h, w) float32 plane pair: cur and
    prev read, the prediction and the int32 vectors written; a
    subtraction, an absolute value and an add per pixel and candidate."""
    n_bytes = 3 * h * w * 4 + (h // mb) * (w // mb) * 2 * 4
    return _bound(n_bytes, h * w * (2 * r + 1) ** 2 * 3 + extra_ops)


def _hold_search(label, name, got, plain, cur, prev, r, mb, bias, compensate):
    """One search kernel's (mv, pred) against its plain version's: the
    prediction equals ``compensate(prev, mv)`` exactly, the vectors equal
    except at float64-verified near-ties. Returns the prediction's max
    |difference| (0)."""
    (mv, pred), (mv_p, _) = got, plain
    d = float((pred - compensate(prev, mv)).abs().max())
    _require(d == 0, f"{name} ({label}): prediction differs from the "
             "compensation of its vectors")
    ties = _near_tie_check(cur, prev, mv, mv_p, r, mb, bias)
    print(f"{name} vs plain ({label}): {ties} of {mv.shape[0] * mv.shape[1]}"
          f" blocks differ, each a float64-verified near-tie; prediction "
          "exact", flush=True)
    return d


def run_hier_kernels(dev):
    """Phase 5b: K6a (8x8 blocks on the pooled 544x960 planes at r=3,
    16x16 on 1088x1920 at r=7), K5 (the whole hier search at r=7) and
    K6b against their plain versions on the K3 pairs, and their times."""
    from flutpu_torch.codec.ops import motion_kernels as M
    from flutpu_torch.codec.ops.colorspace import subsample_420
    from flutpu_torch.codec.ops.motion import compensate_blocks

    import numpy as np
    r, rc = SEARCH_RANGE, max(1, SEARCH_RANGE // 2)
    pairs = _motion_pairs(dev, np.random.default_rng(1))
    out = {}
    err = {"blocks": 0.0, "hier": 0.0, "dygrid": 0.0}
    for label, cur, prev in pairs:
        pc, pp = subsample_420(cur), subsample_420(prev)
        err["blocks"] = max(err["blocks"], _hold_search(
            f"{label}, pooled 544x960, 8x8, r={rc}", "motion_search_mc_blocks",
            M.motion_search_mc_blocks(pc, pp, rc, 8),
            M.motion_search_mc_blocks_plain(pc, pp, rc, 8), pc, pp, rc, 8,
            True, lambda p, m: compensate_blocks(p, m, 8)))
        err["blocks"] = max(err["blocks"], _hold_search(
            f"{label}, 16x16, r={r}", "motion_search_mc_blocks",
            M.motion_search_mc_blocks(cur, prev, r, 16),
            M.motion_search_mc_blocks_plain(cur, prev, r, 16), cur, prev, r,
            16, True, lambda p, m: compensate_blocks(p, m, 16)))
        err["hier"] = max(err["hier"], _hold_search(
            f"{label}, r={r}", "motion_search_mc_hier",
            M.motion_search_mc_hier(cur, prev, r),
            M.motion_search_mc_hier_plain(cur, prev, r), cur, prev, r, 16,
            False, lambda p, m: M.motion_compensate(p, m, r)))
    label, cur, prev = pairs[2]
    err["dygrid"] = _hold_search(
        f"{label}, r={r}", "motion_search_mc_dygrid",
        M.motion_search_mc_dygrid(cur, prev, r),
        M.motion_search_mc_dygrid_plain(cur, prev, r), cur, prev, r, 16,
        True, lambda p, m: M.motion_compensate(p, m, r))

    pc, pp = subsample_420(cur), subsample_420(prev)
    t = {"blocks8": (_time_ms(lambda: M.motion_search_mc_blocks(
             pc, pp, rc, 8), 20), _time_ms(
             lambda: M.motion_search_mc_blocks_plain(pc, pp, rc, 8), 3)),
         "blocks16": (_time_ms(lambda: M.motion_search_mc_blocks(
             cur, prev, r, 16), 20), _time_ms(
             lambda: M.motion_search_mc_blocks_plain(cur, prev, r, 16), 3)),
         "hier": (_time_ms(lambda: M.motion_search_mc_hier(cur, prev, r), 20),
                  _time_ms(lambda: M.motion_search_mc_hier_plain(
                      cur, prev, r), 3)),
         "dygrid": (_time_ms(lambda: M.motion_search_mc_dygrid(
             cur, prev, r), 20), _time_ms(
             lambda: M.motion_search_mc_dygrid_plain(cur, prev, r), 3))}
    coarse, _ = M.motion_search_mc_blocks(pc, pp, rc, 8)
    base = (coarse * 2).clamp(-(r - 1), r - 1)
    refine_ms = _time_ms(lambda: M._launch_search(
        "flu_motion_refine_mc", cur, prev, r, 16, base.data_ptr()), 50)
    print(f"motion_search_mc_blocks: kernel {t['blocks8'][0]:.4f} ms, plain "
          f"{t['blocks8'][1]:.3f} ms per pooled 544x960 plane (8x8, r={rc}); "
          f"kernel {t['blocks16'][0]:.4f} ms, plain {t['blocks16'][1]:.3f} ms "
          f"per 1088x1920 plane (16x16, r={r})", flush=True)
    print(f"motion_search_mc_hier: kernels {t['hier'][0]:.4f} ms (pool + "
          f"K6a + clip + refine), refine kernel alone {refine_ms:.4f} ms, "
          f"plain {t['hier'][1]:.3f} ms per 1088x1920 luma frame (r={r})",
          flush=True)
    print(f"motion_search_mc_dygrid: kernel {t['dygrid'][0]:.4f} ms, plain "
          f"{t['dygrid'][1]:.3f} ms per 1088x1920 luma frame (r={r})",
          flush=True)
    # K6a on the hier path runs at 8x8 on the pooled planes: its record
    # carries that shape's times
    out["motion_search_mc_blocks"] = dict(
        max_abs_err=err["blocks"], ms=t["blocks8"][0],
        plain_ms=t["blocks8"][1], **_search_bound(PH // 2, PW // 2, 8, rc))
    # the whole hier call: the 8x8 coarse search on the pooled planes (its
    # ops; the pooled planes are intermediates) and the 9-candidate refine
    # over the full planes, which read cur and prev and write the
    # prediction and vectors
    coarse_ops = (PH // 2) * (PW // 2) * (2 * rc + 1) ** 2 * 3
    out["motion_search_mc_hier"] = dict(
        max_abs_err=err["hier"], ms=t["hier"][0], plain_ms=t["hier"][1],
        **_search_bound(PH, PW, 16, 1, coarse_ops + 2 * PH * PW))
    out["motion_search_mc_dygrid"] = dict(
        max_abs_err=err["dygrid"], ms=t["dygrid"][0],
        plain_ms=t["dygrid"][1], **_search_bound(PH, PW, 16, r))
    return out


def _psnr(a, b) -> float:
    import numpy as np
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _check_chunks(lib, chunks, sources, label):
    """Phase 7 for a list of chunks and their (F, H, W, 3) uint8 source
    frames (numpy): decode on the card, PSNR, scans against the native
    encoder, and the first chunk's decode on the CPU against the card's
    (a 1080p chunk's CPU decode takes about a second). Returns (lowest
    PSNR, max |dRGB|, max dPSNR)."""
    import numpy as np
    from flutpu_torch.codec.decode import decode_scan_to_coefs
    from flutpu_torch.codec.fvc import FvcDecoder
    card, cpu = FvcDecoder("cuda"), FvcDecoder("cpu")
    worst, d_rgb, d_psnr = float("inf"), 0, 0.0
    for ci, (data, src) in enumerate(zip(chunks, sources)):
        hdr, frames = FvcDecoder.parse_chunk(data)
        _require((hdr["height"], hdr["width"]) == (H, W),
                 f"{label} chunk {ci}: header size")
        for fi, (_, _, payload) in enumerate(frames):
            coefs = decode_scan_to_coefs(payload, PW // 8, PH // 8, PW // 16,
                                         PH // 16, True)
            _require(coefs is not None,
                     f"{label} chunk {ci} frame {fi}: scan does not decode")
            _require(_native_scan(lib, *coefs) == payload,
                     f"{label} chunk {ci} frame {fi}: scan differs from "
                     "flu_jpeg_encode_scan of its coefficients")
        rgb, info = card.decode_chunk(data)
        _require(rgb.shape == src.shape, f"{label}: decoded shape "
                 f"{rgb.shape}")
        worst = min([worst] + [_psnr(a, s) for a, s in zip(rgb, src)])
        if ci:
            continue
        rgb_cpu, info_cpu = cpu.decode_chunk(data)
        _require(info["types"] == info_cpu["types"], f"{label}: types")
        d_rgb = int(np.abs(rgb.astype(np.int32)
                           - rgb_cpu.astype(np.int32)).max())
        d_psnr = max(abs(_psnr(a, s) - _psnr(b, s))
                     for a, b, s in zip(rgb, rgb_cpu, src))
    _require(worst >= MIN_PSNR, f"{label}: PSNR {worst:.2f} dB")
    _require(d_psnr <= MAX_DPSNR, f"{label}: card vs CPU decode differ by "
             f"{d_psnr:.4f} dB")
    return worst, d_rgb, d_psnr


def _count_launches(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before
    and read just after; returns (fn's result, counts)."""
    import torch
    from flutpu_torch.codec.ops import entropy_kernels as K
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.codec.ops import motion_kernels as M
    wrappers = {"front_end": F.front_end, "pack_segments": K.pack_segments,
                "pack_block_bits_fused": K.pack_block_bits_fused,
                "pack_block_bits64": K.pack_block_bits64,
                "pack_block_bits": K.pack_block_bits,
                "motion_search_mc": M.motion_search_mc,
                "chroma_mc": M.chroma_mc,
                "motion_search_mc_hier": M.motion_search_mc_hier,
                "motion_search_mc_blocks": M.motion_search_mc_blocks,
                "motion_search_mc_dygrid": M.motion_search_mc_dygrid}
    torch.cuda.synchronize()
    for w_ in wrappers.values():
        w_.launches = 0
    out = fn()
    return out, {k: w_.launches for k, w_ in wrappers.items()}


def run_fvc(dev, lib):
    """Phases 6 and 7: the FVC main paths and their checks. Returns the
    kernels' launch counts summed over the paths, and the first chunk of
    the v1 and the v2 (P-only) paths (source frames 0-7)."""
    import numpy as np
    from flutpu_torch.codec.fvc import FvcEncoder
    from flutpu_torch.codec.ops.testsrc import (gradient_ball_frames,
                                                gradient_ball_planes)
    from flutpu_torch.core import parse_launch
    from flutpu_torch.core.elements import make_test_frame

    def src(ph, pw, n, start):
        return gradient_ball_planes(ph, pw, n, start, device=dev)

    def sources(n_chunks, first=0):
        return [gradient_ball_frames(PH, PW, CHUNK, first + c * CHUNK,
                                     device=dev)[:, :H, :W].cpu().numpy()
                for c in range(n_chunks)]

    enc = FvcEncoder(QUALITY, motion=True, search_range=SEARCH_RANGE,
                     device=dev)
    # one chunk first so the adaptive sizes are learned, as a stream would
    enc.encode_chunk_finalize(enc.encode_chunk_dispatch_src(src, 0, CHUNK,
                                                            H, W))

    (chunks, span, wall), n_motion = _count_launches(
        lambda: _chunks_in_flight(enc, src, N_CHUNKS))
    sizes = [len(c) for c in chunks]
    print(f"FVC motion path: {N_CHUNKS} chunks x {CHUNK} frames in "
          f"{wall:.3f} s = {N_CHUNKS * CHUNK / wall:.1f} frames/s; device "
          f"span {span:.3f} ms per chunk (CUDA events); "
          f"mean {np.mean(sizes):.0f} bytes per chunk; kernel launches "
          f"{n_motion}", flush=True)
    for name in ("pack_segments", "motion_search_mc", "chroma_mc"):
        _require(n_motion[name] > 0, f"{name} was not launched on the FVC "
                 "motion path")

    v1 = FvcEncoder(QUALITY, motion=False, device=dev)

    def v1_path():
        t0 = time.perf_counter()
        hs = [v1.encode_chunk_dispatch_src(src, c * CHUNK, CHUNK, H, W)
              for c in range(N_V1_CHUNKS)]
        out = [v1.encode_chunk_finalize(hnd) for hnd in hs]
        return out, time.perf_counter() - t0

    (v1_chunks, v1_wall), n_v1 = _count_launches(v1_path)
    print(f"FVC v1 path: {N_V1_CHUNKS} chunks in {v1_wall:.3f} s; "
          f"{np.mean([len(c) for c in v1_chunks]):.0f} bytes per chunk; "
          f"kernel launches {n_v1}", flush=True)
    for name in ("front_end", "pack_segments"):
        _require(n_v1[name] > 0, f"{name} was not launched on the FVC v1 "
                 "path")

    (bufs, pipe_wall), n_pipe = _count_launches(lambda: _pipeline(
        parse_launch, f"videotestsrc num-buffers={FVC_PIPE_FRAMES} "
        f"pattern=ball width={W} height={H} ! cudafvcenc motion=true "
        f"gop-size={CHUNK} device={dev} ! appsink name=out"))
    print(f"FVC pipeline: {len(bufs)} chunks in {pipe_wall:.3f} s; kernel "
          f"launches {n_pipe}", flush=True)
    _require(len(bufs) == FVC_PIPE_FRAMES // CHUNK,
             f"FVC pipeline gave {len(bufs)} chunks")
    pts = [p for b in bufs for p in b.meta["frame_pts"]]
    _require(pts == sorted(pts) and len(pts) == FVC_PIPE_FRAMES,
             "FVC pipeline output out of order")
    for name in ("pack_segments", "motion_search_mc", "chroma_mc"):
        _require(n_pipe[name] > 0, f"{name} was not launched in the FVC "
                 "pipeline")

    pipe_src = [np.stack([make_test_frame("ball", W, H, i)
                          for i in range(c * CHUNK, (c + 1) * CHUNK)])
                for c in range(len(bufs))]
    checks = [("FVC motion", chunks, sources(N_CHUNKS)),
              ("FVC v1", v1_chunks, sources(N_V1_CHUNKS)),
              ("FVC pipeline", [bytes(b.data) for b in bufs], pipe_src)]
    for label, cs, srcs in checks:
        worst, d_rgb, d_psnr = _check_chunks(lib, cs, srcs, label)
        print(f"checks ({label}): {len(cs)} chunks decode on the card at "
              f">= {worst:.2f} dB; scans equal flu_jpeg_encode_scan; CPU "
              f"decode max |dRGB| {d_rgb}, max dPSNR {d_psnr:.4f} dB",
              flush=True)
    _encode_parity(dev)
    return ({k: n_motion[k] + n_v1[k] + n_pipe[k] for k in n_motion},
            {"v1": v1_chunks[0], "v2 P-only": chunks[0]})


def _chunks_in_flight(enc, src, n_chunks):
    """``n_chunks`` chunks of the on-device source through
    dispatch/finalize with two in flight → (chunks, device span per chunk
    in ms (CUDA events), wall seconds)."""
    return _in_flight(
        lambda ci: enc.encode_chunk_dispatch_src(src, ci * CHUNK, CHUNK, H,
                                                 W),
        enc.encode_chunk_finalize, n_chunks)


def run_fvc_hier_b(dev, lib):
    """Phase 8: FVC v2 with B frames and the hier search (the slice's
    main path), its neighbours (config 6b: full search + B; P-only hier;
    the dy-grid search arm), their decode checks, and a 544x960 hier+B
    chunk on the card against the CPU. Returns the launch counts summed
    over the paths, and the main path's first chunk (source frames 0-7)."""
    import numpy as np
    from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
    from flutpu_torch.codec.ops.testsrc import (gradient_ball_frames,
                                                gradient_ball_planes)

    def src(ph, pw, n, start):
        return gradient_ball_planes(ph, pw, n, start, device=dev)

    def sources(n_chunks):
        return [gradient_ball_frames(PH, PW, CHUNK, c * CHUNK,
                                     device=dev)[:, :H, :W].cpu().numpy()
                for c in range(n_chunks)]

    def encoder(**kw):
        enc = FvcEncoder(QUALITY, motion=True, search_range=SEARCH_RANGE,
                         device=dev, **kw)
        # one chunk first so the adaptive sizes are learned
        enc.encode_chunk_finalize(enc.encode_chunk_dispatch_src(
            src, 0, CHUNK, H, W))
        return enc

    total = {}
    enc = encoder(hier=True, bframes=1)
    (chunks, span, wall), n = _count_launches(
        lambda: _chunks_in_flight(enc, src, N_CHUNKS))
    print(f"FVC hier+B path (search=hier bframes=1): {N_CHUNKS} chunks x "
          f"{CHUNK} frames in {wall:.3f} s = {N_CHUNKS * CHUNK / wall:.1f} "
          f"frames/s; device span {span:.3f} ms per chunk (CUDA events); "
          f"mean {np.mean([len(c) for c in chunks]):.0f} bytes per chunk; "
          f"kernel launches {n}", flush=True)
    for name in ("motion_search_mc_hier", "motion_search_mc_blocks",
                 "chroma_mc", "pack_segments"):
        _require(n[name] > 0, f"{name} was not launched on the hier+B path")
    for k, v in n.items():
        total[k] = total.get(k, 0) + v
    checks = [("FVC hier+B", chunks, sources(N_CHUNKS), True)]
    first = chunks[0]

    neighbours = [("FVC full+B (config 6b)", dict(bframes=1), {},
                   "motion_search_mc", True),
                  ("FVC hier P-only", dict(hier=True), {},
                   "motion_search_mc_hier", False),
                  ("FVC dy-grid P-only", {}, {"FLUTPU_SEARCH_DYGRID": "1"},
                   "motion_search_mc_dygrid", False)]
    for label, kw, env, kernel, has_b in neighbours:
        os.environ.update(env)
        try:
            enc = encoder(**kw)
            (one, span, wall), n = _count_launches(
                lambda: _chunks_in_flight(enc, src, 1))
        finally:
            for k in env:
                os.environ.pop(k)
        print(f"{label}: 1 chunk in {wall:.3f} s, device span {span:.3f} ms, "
              f"{len(one[0])} bytes; kernel launches {n}", flush=True)
        _require(n[kernel] > 0, f"{kernel} was not launched on the {label} "
                 "path")
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        checks.append((label, one, sources(1), has_b))

    for label, cs, srcs, has_b in checks:
        worst, d_rgb, d_psnr = _check_chunks(lib, cs, srcs, label)
        types = [t for c in cs for t, _, _ in FvcDecoder.parse_chunk(c)[1]]
        _require((2 in types) == has_b, f"{label}: frame types {types}")
        print(f"checks ({label}): {len(cs)} chunks decode on the card at "
              f">= {worst:.2f} dB; frame types {sorted(set(types))}; scans "
              f"equal flu_jpeg_encode_scan; CPU decode max |dRGB| {d_rgb}, "
              f"max dPSNR {d_psnr:.4f} dB", flush=True)

    frames = gradient_ball_frames(544, 960, CHUNK, 0, device="cpu").numpy()
    kw = dict(motion=True, hier=True, bframes=1)
    a = FvcEncoder(QUALITY, device=dev, **kw).encode_chunk(frames)
    b = FvcEncoder(QUALITY, device="cpu", **kw).encode_chunk(frames)
    if a == b:
        print("card vs CPU encode (544x960 hier+B chunk): byte-identical",
              flush=True)
    else:
        # a rounding tie (cuBLAS vs the CPU's in-loop DCT): hold the
        # streams to the tie contract
        dec = FvcDecoder("cpu")
        (ra, ia), (rb, ib) = dec.decode_chunk(a), dec.decode_chunk(b)
        dp = max(abs(_psnr(x, s) - _psnr(y, s))
                 for x, y, s in zip(ra, rb, frames))
        print(f"card vs CPU encode (544x960 hier+B chunk): DIFFERENT ({len(a)}"
              f" vs {len(b)} bytes; types {ia['types']} vs {ib['types']}; "
              f"max dPSNR {dp:.4f} dB)", flush=True)
        _require(ia["types"] == ib["types"] and dp <= MAX_DPSNR,
                 "card vs CPU hier+B encode breaks the tie contract")
    return total, first


def run_fvc_blocks(dev, lib, seg_chunks):
    """Phase 9: one chunk each of FVC v1, v2 P-only and hier+B without
    segments (K7), each byte-identical to the segmented chunk of the same
    source (``seg_chunks``: the first chunk of phases 6 and 8, by label)
    and checked as in phase 7. Returns the launch counts."""
    from flutpu_torch.codec.fvc import FvcEncoder
    from flutpu_torch.codec.ops.testsrc import (gradient_ball_frames,
                                                gradient_ball_planes)

    def src(ph, pw, n, start):
        return gradient_ball_planes(ph, pw, n, start, device=dev)

    srcs = [gradient_ball_frames(PH, PW, CHUNK, 0, device=dev)[:, :H, :W]
            .cpu().numpy()]
    total = {}
    for label, kw in (("v1", dict(motion=False)), ("v2 P-only", {}),
                      ("hier+B", dict(hier=True, bframes=1))):
        kw = dict(dict(motion=True, search_range=SEARCH_RANGE), **kw)
        enc = FvcEncoder(QUALITY, segmented=False, device=dev, **kw)
        (one, span, wall), n = _count_launches(
            lambda: _chunks_in_flight(enc, src, 1))
        print(f"FVC {label} without segments: 1 chunk in {wall:.3f} s, "
              f"device span {span:.3f} ms, {len(one[0])} bytes; kernel "
              f"launches {n}", flush=True)
        _require(n["pack_block_bits_fused"] > 0 and n["pack_segments"] == 0,
                 f"FVC {label} without segments did not run K7 alone")
        _require(one[0] == seg_chunks[label], f"FVC {label}: the "
                 "non-segment chunk differs from the segmented one")
        worst, d_rgb, d_psnr = _check_chunks(lib, one, srcs,
                                             f"FVC {label} non-segment")
        print(f"checks (FVC {label} non-segment): equal to the segmented "
              f"chunk; decodes on the card at >= {worst:.2f} dB; CPU decode "
              f"max |dRGB| {d_rgb}, max dPSNR {d_psnr:.4f} dB", flush=True)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    return total


def _encode_parity(dev):
    """A measurement, not a check: one 544x960 motion chunk encoded on the
    card and on the CPU (the kernels' plain versions). Byte identity can
    break where the card's in-loop DCT (cuBLAS) rounds a coefficient
    across a quantization tie differently from the CPU's."""
    import numpy as np
    from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
    from flutpu_torch.codec.ops.testsrc import gradient_ball_frames
    frames = gradient_ball_frames(544, 960, CHUNK, 0, device="cpu").numpy()
    a = FvcEncoder(QUALITY, motion=True, device=dev).encode_chunk(frames)
    b = FvcEncoder(QUALITY, motion=True, device="cpu").encode_chunk(frames)
    if a == b:
        print("card vs CPU encode (544x960 motion chunk): byte-identical",
              flush=True)
        return
    (ha, fa), (hb, fb) = FvcDecoder.parse_chunk(a), FvcDecoder.parse_chunk(b)
    mv_diff = sum(int((x[1] != y[1]).any(-1).sum()) for x, y in zip(fa, fb)
                  if x[1] is not None and y[1] is not None)
    dec = FvcDecoder("cpu")
    pa = [_psnr(x, s) for x, s in zip(dec.decode_chunk(a)[0], frames)]
    pb = [_psnr(x, s) for x, s in zip(dec.decode_chunk(b)[0], frames)]
    print(f"card vs CPU encode (544x960 motion chunk): DIFFERENT "
          f"({len(a)} vs {len(b)} bytes; frame types "
          f"{[f[0] for f in fa]} vs {[f[0] for f in fb]}; {mv_diff} vectors "
          f"differ; max dPSNR {max(abs(x - y) for x, y in zip(pa, pb)):.4f} "
          f"dB, mean PSNR {np.mean(pa):.2f} vs {np.mean(pb):.2f} dB)",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
