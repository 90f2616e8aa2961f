#!/usr/bin/env python3
"""Smoke run of flutpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Drives the port's main paths through the entry points a user calls, at
1080p (coded 1088x1920), quality 85, 4:2:0:

1. build: compiles the CUDA kernels from ``flutpu_torch/csrc`` with nvcc
   (one nvcc per source, all started together);
2. JPEG kernels: on one 16-frame GOP, the front-end kernel (K1) against
   its plain PyTorch version (equal except ±1 on rounding ties, on at
   most 1e-4 of the coefficients), its output on a seeded noise GOP
   against the pinned SHA-256 of the first port's kernel, and its
   quantizer's division against IEEE division on every pair it can meet;
   the Huffman pack kernel (K2, a lane per block) against its plain
   version (bit-identical) on that GOP and on the noise GOP's
   coefficients, at ``seg_words`` 64 and 8; each timed with CUDA events
   (K2 on both GOPs);
2b. block-pack kernels (the non-segment layout): on the MCU blocks of
   the gradient-ball GOP and of the noise GOP (K1's coefficients through
   ``_mcu_blocks``), K7, K8a (on ``_slot_tables_merged``) and K8b (on
   ``_slot_tables``) each bit-identical to its plain version and the
   three to each other, each timed beside its byte bound;
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
   to its plain version at search ranges 7, 5 and 32 (random vectors,
   odd negative ones among them); both timed;
5b. hier and block-size kernels: K6a (the search kernel's 8x8 instance
   on the three pairs pooled to 544x960 at r=3, its 16x16 instance at
   r=7), K5 (the whole hier search in one launch, at r = 1, 2, 3, 7, 16
   and 32 on the three pairs, a flat pair and a pair with NaN) and K6b
   (K3's contract) against their plain versions, held as K3 is; each
   timed, and one call of K5 profiled (one device launch);
6. FVC main paths: ``FvcEncoder(motion=True).encode_chunk_dispatch_src``,
   6 chunks of 8 frames with two in flight (K2, K3, K4 launched), then
   2 chunks of FVC v1 (K1, K2), then the pipeline
   ``videotestsrc ! cudafvcenc motion=true ! appsink`` over 16 frames;
7. FVC checks: every chunk decodes through the port's ``FvcDecoder`` on
   the card at >= 30 dB, every payload's scan equals the native
   ``flu_jpeg_encode_scan`` of its decoded coefficients, and the CPU
   decode (plain PyTorch) of each path's first chunk equals the card's
   frames bit for bit;
8. FVC hier+B main path: ``FvcEncoder(motion=True, hier=True,
   bframes=1)``, 6 chunks of 8 frames with two in flight (K5, K4, K2
   launched), then one chunk each of its neighbours (``bframes=1``
   with the full search through K3: BASELINE config 6b; P-only hier;
   P-only with ``FLUTPU_SEARCH_DYGRID=1`` through K6b), all decoded and
   checked as in phase 7 with B frames (type 2) where expected; device
   busy time and device launches per chunk of hier+B and of P-only hier
   (torch.profiler, 4 chunks each); and a 544x960 hier+B chunk encoded on
   the card and on the CPU: byte-identical;
9. FVC without segments: one chunk each of v1, v2 P-only and hier+B with
   ``segmented=False`` (K7 launched, K2 not), each byte-identical to the
   segmented chunk of the same source (the first chunk of phases 6 and 8)
   and checked as in phase 7;
10. subtitle burn-in (BASELINE config 5, encode + TTML burn-in):
   a. K1 with its overlay branch on one 16-frame GOP and a seeded BGRA
      overlay of 1080 rows (opaque, half-transparent and alpha-0 bands):
      against its plain version under K1's contract, bit-identical to K1
      on planes blended beforehand (``overlay_on_planes``), and with
      alpha 0 bit-identical to K1 without an overlay; timed beside its
      byte bound and beside the launch without an overlay;
   b. the renderer: config 5's document through ``cudattmlrender
      window-width=1920 window-height=1088 device-out=true`` on the card
      and through the same element on the CPU, equal pixel for pixel and
      not blank; a second document (5 intervals, an outline, a region
      opacity) batched, with and without ``crop-delivery``, per interval
      and on the CPU: equal frames; the compositor on seeded tiles and
      instance tables, card against CPU; device launches and busy ms
      per interval (torch.profiler); the font backend;
   c. the main path: ``JpegEncoder.encode_gop_dispatch_src(..., overlay=
      window)``, 8 GOPs with two in flight (K1's overlay branch and K2
      launched), then 2 GOPs with ``segmented=False`` (K1 and K7),
      byte-identical between the layouts; every scan checked as in phase
      4 against K1-with-overlay's coefficients, every frame >= 30 dB from
      its source blended on the CPU and different from the unblended
      source under the subtitle; frames/s and device busy time per GOP
      beside the plain JPEG path's from interleaved loops;
   d. the pipeline: ``videotestsrc`` -> ``comp.video``, the document ->
      ``cudattmlrender device-out=true`` -> ``comp.overlay``,
      ``cudaoverlaycompositor name=comp ! cudajpegenc ! appsink``, 32
      frames, every frame decoded and checked, the frames inside the
      subtitle's interval carrying it and the others not.

11. the test source on the card: ``gradient_ball_planes`` on the card
   equal to the CPU's, value for value, at 96x160, 1088x1920 and
   2160x3840 (its ramps divide by a tensor: given a Python number the
   card would multiply by a reciprocal);
12. 4K (2160x3840, BASELINE configs 4 and 5): K1 on an 8-frame GOP
   against its plain version, without and with a seeded (2160, 3840, 4)
   overlay (which must equal K1 on planes blended beforehand), timed
   beside its byte bound; K3 on one 4K luma pair at r=7 against its plain
   version; one 8-frame 4K GOP through
   ``JpegEncoder.encode_gop_dispatch_src`` / ``encode_gop_finalize``,
   checked as in phase 4; ``cudaoverlaycompositor.prewarm`` at 4K;
13. GOP-chunk parallelism (BASELINE config 3: a 1080p30 10 s clip in
   GOP chunks, parallel encode and ordered stitch):
   a. ``videotestsrc`` 300 frames ``! hype gop-size=30
      encoder-0..3=cudajpegenc ! appsink``: four encoder branches share
      the card from their own streaming threads; every frame in order,
      decoding to K1's coefficients at >= 30 dB, byte-identical to one
      ``JpegEncoder`` of the same frames;
   b. the same frames through ``cudahype codec=jpeg chunks=8
      gop-size=30`` (8 chunks per dispatch): the same checks, bytes
      identical to (a);
   c. ``cudahype codec=fvc-motion chunks=8 gop-size=8`` on 64 frames,
      then ``search=hier bframes=1`` on 70 (a truncated tail): every
      chunk decodes through ``FvcDecoder`` on the card at >= 30 dB, with
      B frames where expected; each chunk against a per-chunk
      ``FvcEncoder`` on the card: byte-identical (``_require_same``);
   d. ``injectbin`` swaps a prewarmed ``cudajpegenc`` into a running
      720p ``videotestsrc ! injectbin ! appsink`` stream: no buffer lost
      or reordered, the largest gap between outputs printed (BASELINE
      config 2's swap, less the decoder);
   e. K3, K5 and K4 with a chunk axis: 8 chunks' 1080p planes in one
      launch each equal to the chunk's own launch (and K4 to its plain
      version, K3 and K5 to theirs but for float64-verified near-ties),
      timed beside 8 single-chunk launches;
   for (a)-(c) frames/s, the peak device memory, and device busy ms and
   launches per chunk (torch.profiler);
14. the decode side (the decoders reconstruct in plain PyTorch on the
   card after the host's native scan decode):
   a. BASELINE config 2 as written: 90 frames of 720p ``videotestsrc
      pattern=ball`` encoded once by ``cudajpegenc``, the JFIF bytes in
      host memory, fed live at 30 frames/s through ``appsrc !
      cudajpegdec ! injectbin ! appsink``; at frame 30 a prewarmed
      ``cudaoverlaycompositor`` whose ``overlay`` pad holds a seeded
      window is swapped in: no frame lost or reordered, the frames before
      the swap equal ``cudajpegdec``'s plain decode, those after the CPU
      blend of it (±1), every frame >= 30 dB, the largest output gap
      beside the median;
   b. config 3 at contract scale: 13b's 300 frames through ``cudahype
      codec=jpeg chunks=8 gop-size=30 ! avimux ! avidemux ! cudajpegdec``
      (in order; the AVI's frames are the JFIF buffers that entered
      ``avimux``, byte for byte; >= 30 dB, PSNR on the card), the decoder
      alone from host memory under the profiler; 13c's FVC chunks
      concatenated: ``FvcDecoder.decode_stream`` on the card equal to
      per-chunk ``decode_chunk``, and ``cudafvcdec`` fed 4096-byte blocks
      the same frames;
   c. half-pel: ``FvcEncoder(motion=True, subpel=True)``, 2 chunks of 8
      at 1080p, full and hier search (K3, K5 launched, K4 not), each
      through ``cudafvcdec`` >= 30 dB and the CPU decode equal to it;
      ``cudahype codec=fvc-motion subpel=true chunks=8`` on 64 frames,
      each chunk byte-identical to a per-chunk encode; 4:4:4: one
      16-frame ``JpegEncoder
      (subsample=False)`` GOP and one ``FvcEncoder(subsample=False)``
      chunk (K2 launched, K1 not) under phase 4's checks against the
      plain 4:4:4 front end, decoded through ``cudajpegdec`` /
      ``cudafvcdec`` at >= 30 dB;
   d. header flags bit 4: a 1088-row chunk rewritten to 1080 rows plus
      the coded-size extension decodes to the 1088-row decode's crop;
15. the FVC encoder's remaining options:
   a. search ranges above 32: K3 at r = 33, 48, 64 and 126 on two of
      phase 5's 1080p pairs, K6a (8x8) at 64 on their pooled planes, K5
      at 40, 64 and 126 (also on a flat pair and a pair with NaN; one
      launch per call), held as in phase 5 and timed beside their
      bounds and their fp32 issue floors (2 instructions per absolute
      difference), the SM clock sampled by ``nvidia-smi`` meanwhile;
      K4 on vectors to ±126; K3 at C = 8 and r = 64, each chunk
      equal to its own launch, timed beside 8 single launches;
   b. ``cudafvcenc motion=true search-range=64 gop-size=8`` (full and
      ``search=hier``) on 16 frames of a seeded 1080p pan of 48 columns
      and 8 rows per frame: every chunk through ``cudafvcdec`` at >= 30
      dB, the CPU decode equal to it, vectors beyond ±32, and a
      smaller stream than at ±32;
   c. ``cudafvcenc motion=true bitrate=6000000 gop-size=8`` on 64
      frames of 1080p gradient-ball at 30 frames/s: each chunk's quality
      is flutpu's controller's for the sizes before it (replayed on the
      host), every chunk decoded on the card and the CPU;
   d. the slice's main path: 48 frames of 1080p ``videotestsrc
      pattern=ball ! cudafvcladderenc rungs=...@85,...@80,...@75
      motion=true bframes=1 gop-size=8 adaptive=true`` into four
      appsinks: each rung's chunk equals a card ``FvcEncoder``'s on the
      same scaled frames, the card's scaled frames lie within one level
      of the CPU's, every rung decodes at >= 30 dB, and a meter fed a
      fast, a slow and a fast link moves ``src_active`` to the lowest
      rung and back; frames/s, device busy and launches per chunk and
      rung;
   e. ``encode_chunk_batch_dispatch_src`` of 4 chunks: one device-to-host
      copy; each chunk byte-identical to its own
      ``encode_chunk_dispatch_src``;
   f. the downloader on a ``file://`` file and a loopback HTTP URL (the
      bandwidth meter counts their bytes), and a loopback-URL background
      image rendered through ``cudattmlrender`` on the card
      pixel-identical to the same image embedded as ``#id``;
16. several shards and row stripes (BASELINE config 4), in a process of
   its own:
   a. config 4: 240 4K (2160x3840) gradient-ball frames from host memory
      through ``cudahype codec=jpeg spatial=2 gop-size=30 chunks=8``
      (chunks=4 where the peak device memory passes 70 GiB; the peak and
      the choice printed): K1 per stripe, the planes cropped to the
      standard MCU rows, every JFIF byte-identical to ``spatial=1`` and
      under phase 4's checks; busy ms and launches per chunk of both
      (torch.profiler), then frames/s of both in turns;
   b. a seeded 4K pan of 4 rows and 6 columns per frame, 16 frames,
      through ``cudahype codec=fvc-motion spatial=2 chunks=2 gop-size=8
      search-range=7``, P only and ``bframes=1``: header flags bit 4
      (coded 2176 rows), >= 30 dB through ``FvcDecoder``, vectors with
      dy != 0 on the macroblock rows at the stripe edge, K3 and K4
      launched and K5 not, each chunk's frame records equal to
      ``spatial=1``'s on the frames padded to 2176 rows; busy ms and
      launches per chunk beside ``spatial=1``'s;
   c. ``encode_chunks`` and ``FvcEncoder.encode_chunks_dispatch`` on
      meshes of 2 and 4 shards and a (2, 2) grid of the card (and of
      distinct cards where there are two or more): K1's coefficients
      equal one shard's, FVC chunks byte-identical to one shard's;
   d. two ``tests/torch_multihost_worker.py`` processes on the card over
      a gloo group: the stitched chunks equal one process's;
   e. ``composite_instances_batch_vmap`` on 4 intervals of seeded tiles
      equal to ``composite_instances_batch``; launches and busy ms per
      call of both.
17. the command-line tools and the examples, at 1080p:
   a. ``flutpu_torch.launch.main`` in this process: 64 frames of
      ``videotestsrc pattern=ball ! cudajpegenc batch-frames=16 !
      filesink``, 64 JFIF byte-identical to the same line through
      ``appsink`` and under phase 4's checks (K1, K2); 32 frames through
      ``cudafvcenc motion=true gop-size=8 ! filesink``, read back by
      ``FvcDecoder.decode_stream`` at >= 30 dB and under phase 7's checks
      (K3, K4, K2; not K1); frames/s of each (config 3 through
      ``cudahype ! avimux`` runs in phase 14b);
   b. child processes: ``python -m flutpu_torch.launch`` on 32 frames of
      the JPEG line writes the in-process bytes; naming a card past the
      last exits 1 within 30 s with the error printed (no CPU fallback);
      ``python -m flutpu_torch.inspect`` lists 28 factories and
      ``--markdown`` equals docs/ELEMENTS_TORCH.md; a process that
      builds the reference leaves ``torch.cuda.is_initialized()`` false;
   c. the seven ``examples/torch/*.py`` at their defaults on the card,
      side by side in child processes (``mesh_encode`` as ``jpeg`` and
      ``fvc-motion 2``, ``multidl`` on a ``file://`` URL and a loopback
      server): each exits 0, ``encode_parallel`` >= 30 dB,
      ``inject_swap`` JPEG after the swap, ``fvc_batched`` equal or
      within 0.01 dB, ``subtitle_burnin`` a PNG whose subtitle region
      differs from the source frame.
18. the host entropy engine, the coefficient-level API and the planar
   in-loop DCT, at 1080p:
   a. 4 GOPs of 16 gradient-ball frames, two in flight, through
      ``JpegEncoder(engine="host")`` and ``engine="device"``: the JFIF
      byte-identical, K1 launched and no pack kernel in the host arm,
      the native library loaded, the first GOP under phase 4's checks;
      frames/s, device ms (CUDA events) and host ms per GOP of each arm;
      ``videotestsrc ! cudajpegenc engine=host ! appsink`` byte-identical
      to ``engine=device``;
   b. 2 chunks of 8 frames, motion P (full search) and motion + B with
      ``hier``, through ``FvcEncoder(engine="host")`` and
      ``engine="device"``: chunks byte-identical, K3 or K5 and K4
      launched and no pack kernel in the host arm, the host chunks under
      phase 7's checks; frames/s, device and host ms per chunk of each
      arm; the host engine's ``encode_chunk_batch_dispatch_src`` of the
      same 2 chunks byte-identical to the device engine's;
   c. one motion chunk with ``planar = True``, unstriped and on 2 and 4
      row stripes of the card: header flags bit 3, the chunk's coefficients
      the loop's, the decoder's planes equal to the encoder's in-loop
      planes in every frame, PSNR within 0.1 dB of the per-block chunk,
      the planar products the CPU's bits with TF32 matmuls on and off;
      ``encode_gop_scans`` on K1's coefficients of those 8 frames, fused
      (K7) and not (K8a), equal to its plain version on the card (the
      same stages with each pack's plain PyTorch version) in every
      frame's whole scan.
19. the in-loop transform kernels (K9: ``block_dct``, ``block_idct``,
   which ``plane_dct`` / ``plane_idct`` launch on the card) against their
   plain versions run on the CPU, bit for bit (the float32 words
   compared), on 1088x1920 luma at C = 1 and C = 8, a 544x960 chroma
   pair, a 1120-row 4K stripe, a non-contiguous view and the decoder's
   ``dequantize(zigzag_unflatten(q))`` coefficients, inputs with -0 among
   them; each timed (CUDA events) beside the cuBLAS route it replaced
   (the plain version on the card), the plain CPU time and its byte
   bound; phases 6 and 8's traces of the 8-frame 1080p FVC P and hier+B
   chunks read back: busy ms and device launches per chunk beside those
   before K9, K9 in them and no GEMM kernel.

Each main path runs with every kernel's launch count set to 0 just
before it and read just after; a kernel of the path that was not
launched fails the run. Prints each phase's wall time, the card's name
and power limit, the redesigned kernels' times before (``EARLIER_MS``)
and after their redesign, one JSON
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


def _native_scan(lib, y, cb, cr, subsample: bool = True) -> bytes:
    """flu_jpeg_encode_scan of one frame's (BH, BW, 64) int16 planes
    (4:2:0, or 4:4:4 without ``subsample``)."""
    import numpy as np
    from flutpu_torch.codec.jpeg import _encode_scan_native
    out = _encode_scan_native(lib, *(np.ascontiguousarray(a, np.int16)
                                     for a in (y, cb, cr)), subsample)
    _require(out is not None, "flu_jpeg_encode_scan failed")
    return out


def _check_frames(lib, payloads, coefs, sources, enc, label,
                  size=(H, W, PH, PW), subsample=True):
    """Every payload against the front end's coefficients and its source.
    coefs: (y, cb, cr) device int16 of the GOP; sources: (F, H, W, 3)
    uint8 device frames; size: frame and coded (H, W, PH, PW);
    ``subsample``: 4:2:0, else 4:4:4. Returns the lowest PSNR."""
    H, W, PH, PW = size
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
        c = 16 if subsample else 8
        _require(info["subsample"] == subsample, f"{label} frame {i}: SOF0 "
                 "sampling")
        dec = decode_scan_to_coefs(info["scan"], PW // 8, PH // 8, PW // c,
                                   PH // c, subsample)
        _require(dec is not None, f"{label} frame {i}: scan does not decode")
        for a, b_, name in zip(dec, (y[i], cb[i], cr[i]), "y cb cr".split()):
            _require(np.array_equal(a, b_), f"{label} frame {i}: decoded "
                     f"{name} differs from the kernel's coefficients")
        _require(info["scan"] == _native_scan(lib, y[i], cb[i], cr[i],
                                              subsample),
                 f"{label} frame {i}: scan differs from flu_jpeg_encode_scan")
    rgb = coefs_to_rgb(*coefs, enc._qy_dev, enc._qc_dev, H, W,
                       subsample=subsample)
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == [TRACE_CHECKS]:
        print(json.dumps(_trace_checks(torch.device("cuda", 0))))
        return 0
    if sys.argv[1:2] == [PHASE16]:
        counts = _phase16(torch.device("cuda", 0))
        with open(sys.argv[2], "w") as f:
            json.dump(counts, f)
        return 0
    print(_smi(), flush=True)
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

    src = gradient_ball_planes(PH, PW, GOP, 0, device=dev)
    coefs0, err_src = _k1_compare(src, qy, qc, "gradient-ball GOP")
    noise = _noise_gop(dev)
    coefs_n, err_noise = _k1_compare(noise, qy, qc, "uniform-noise GOP")
    _hold_k1_hash("noise", coefs_n)
    _hold_k1_hash("noise+overlay", F.front_end(*noise, qy, qc,
                                               overlay=_seeded_overlay(dev)))
    del noise
    t0 = time.perf_counter()
    pairs, bad = F.quotient_check(dev)
    print(f"front_end quantizer: the reciprocal quotient equals IEEE "
          f"division on {pairs} pairs (divisors 1..255, every float of "
          f"magnitude 2^-3..2^12), {bad} differ; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    _require(pairs > 6e10 and bad == 0,
             f"the kernel's quotient differs from __fdiv_rn on {bad} pairs")
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

    gops = {"gradient-ball": segment_blocks(*coefs0, layout),
            "uniform-noise": segment_blocks(*coefs_n, layout)}
    k2_err = 0
    for label, (zz, comp_f) in gops.items():
        nnz = (zz[:, 1:] != 0).sum(dim=1)[comp_f >= 0]
        print(f"{label} GOP: {nnz.numel()} blocks, AC coefficients per "
              f"block: mean {float(nnz.float().mean()):.3f}; share with "
              f"0 {float((nnz == 0).float().mean()):.3f}, 1 "
              f"{float((nnz == 1).float().mean()):.3f}, 2-8 "
              f"{float(((nnz > 1) & (nnz <= 8)).float().mean()):.3f}, "
              f"over 32 {float((nnz > 32).float().mean()):.3f}", flush=True)
        for sw in (JpegEncoder.SEG_WORDS0, 8):
            buf, bits = K.pack_segments(zz, comp_f, 16, sw)
            pbuf, pbits = K.pack_segments_plain(zz, comp_f, 16, sw)
            over = int((pbits > sw * 32).sum())
            same = torch.equal(buf, pbuf) and torch.equal(bits, pbits)
            print(f"pack_segments vs plain ({label} GOP, seg_words={sw}, "
                  f"{bits.numel()} segments, {over} over capacity): "
                  f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
            _require(same, f"pack_segments differs from its plain version "
                     f"on the {label} GOP at seg_words={sw}")
            k2_err = max(k2_err, int((buf.to(torch.int64)
                                      - pbuf.to(torch.int64)).abs().max()))
    del buf, pbuf
    sw = JpegEncoder.SEG_WORDS0
    k2_ms = {label: _time_ms(lambda: K.pack_segments(zz, comp_f, 16, sw), 20)
             for label, (zz, comp_f) in gops.items()}
    zz, comp_f = gops["gradient-ball"]
    k2_plain_ms = _time_ms(lambda: K.pack_segments_plain(zz, comp_f, 16, sw),
                           3)
    s_count = zz.shape[0] // 16
    bound = _bound(zz.shape[0] * (64 + 1) * 4 + s_count * (sw + 1) * 4)
    print(f"pack_segments: kernel {k2_ms['gradient-ball']:.4f} ms "
          f"(uniform-noise GOP {k2_ms['uniform-noise']:.4f}), plain "
          f"{k2_plain_ms:.3f} ms per 16-frame 1080p GOP ({zz.shape[0]} "
          f"blocks); bound {bound['bound_ms']:.4f} ms", flush=True)
    results["pack_segments"] = dict(max_abs_err=k2_err,
                                    ms=k2_ms["gradient-ball"],
                                    plain_ms=k2_plain_ms, **bound)
    del zz, comp_f, gops
    lap("2 K1, K2")
    results.update(run_block_packs(coefs0, coefs_n, layout))
    del coefs0, coefs_n, src
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
    k1_overlay, counts = run_burnin(dev, lib, results["front_end"]["ms"])
    results["front_end_overlay"] = k1_overlay
    add(counts)
    lap("10 burn-in")
    run_source_check(dev)
    lap("11 source card == CPU")
    add(run_4k(dev, lib))
    lap("12 4K")
    add(run_hype(dev, lib, lap, {k: results[k]["ms"] for k in (
        "motion_search_mc", "motion_search_mc_hier", "chroma_mc")}))
    add(run_decode(dev, lib, lap))
    counts, wide = run_wide(dev, lib, lap)
    add(counts)
    results.update(wide)
    add(run_striped(dev, lib, lap))
    add(run_cli(dev, lib, lap))
    add(run_host_engine(dev, lib, lap))
    results.update(run_transform(dev))
    lap("19 K9 transform")
    for name, key, was in EARLIER_MS:
        r_ = results[name]
        print(f"{key}: {was:.4f} ms before the redesign (PERF.md, same card "
              f"model and power limit), {r_['ms']:.4f} ms now, bound "
              f"{r_['bound_ms']:.4f} ms ({r_['ms'] / r_['bound_ms']:.1f}x)",
              flush=True)
    print(f"phase wall times (s): {json.dumps(lap.secs)}; "
          f"{time.perf_counter() - _T_START:.2f} s since the script started",
          flush=True)

    kernels = [
        dict(name="front_end", route="cuda",
             source="flutpu_torch/csrc/frontend.cu",
             replaces="flutpu/codec/ops/frontend_pallas.py:179",
             launches=launches["front_end"], **results["front_end"]),
        dict(name="front_end_overlay", route="cuda",
             source="flutpu_torch/csrc/frontend.cu",
             replaces="flutpu/codec/ops/frontend_pallas.py:122",
             launches=launches["front_end_overlay"],
             **results["front_end_overlay"]),
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
        dict(name="motion_search_mc_wide", route="cuda",
             source="flutpu_torch/csrc/motion.cu",
             replaces="flutpu/codec/ops/motion_pallas.py:288",
             launches=launches["motion_search_mc_wide"],
             **results["motion_search_mc_wide"]),
        dict(name="motion_search_mc_hier_wide", route="cuda",
             source="flutpu_torch/csrc/motion.cu",
             replaces="flutpu/codec/ops/motion_pallas.py:444",
             launches=launches["motion_search_mc_hier_wide"],
             **results["motion_search_mc_hier_wide"]),
        dict(name="motion_search_mc_blocks_wide", route="cuda",
             source="flutpu_torch/csrc/motion.cu",
             replaces="flutpu/codec/ops/motion_pallas.py:122",
             launches=launches["motion_search_mc_blocks_wide"],
             **results["motion_search_mc_blocks_wide"]),
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
        # K9 has no Pallas original: it replaces flutpu's XLA products
        # (plane_dct, plane_idct), which the port ran on cuBLAS
        dict(name="block_dct", route="cuda",
             source="flutpu_torch/csrc/transform.cu",
             replaces="flutpu/codec/ops/dct.py:62",
             launches=launches["block_dct"], **results["block_dct"]),
        dict(name="block_idct", route="cuda",
             source="flutpu_torch/csrc/transform.cu",
             replaces="flutpu/codec/ops/dct.py:67",
             launches=launches["block_idct"], **results["block_idct"]),
    ]
    for k in kernels:
        # no single torch call computes K1-K8b; K9 carries the cuBLAS route
        k.setdefault("library_ms", None)
    jax_side = sorted(m for m in sys.modules if m in ("jax", "flutpu")
                      or m.startswith(("jax.", "flutpu.")))
    _require(not jax_side, f"imported from the JAX side: {jax_side}")
    return kernels


def _noise_gop(dev):
    """The seeded uniform-noise GOP: (r, g, b) u8 planes (GOP, PH, PW)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.integers(0, 256, (GOP, PH, PW),
                                               np.uint8)).to(dev)
                 for _ in range(3))


def _seeded_overlay(dev, rng=None):
    """Phase 10a's (H, W, 4) BGRA overlay: seeded noise with opaque,
    half-transparent and alpha-0 bands. ``rng``: a fresh
    ``default_rng(5)``, advanced by the draw."""
    import numpy as np
    import torch
    rng = rng or np.random.default_rng(5)
    ov = rng.integers(0, 256, (H, W, 4), np.uint8)
    ov[:300, :, 3], ov[300:600, :, 3], ov[600:800, :, 3] = 255, 128, 0
    return torch.from_numpy(ov).to(dev)


def _coef_hash(coefs) -> str:
    """SHA-256 over the bytes of K1's (y, cb, cr) int16 coefficients."""
    import hashlib
    h = hashlib.sha256()
    for c in coefs:
        h.update(c.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# K1's output on the seeded noise GOP (q85), without and with the seeded
# overlay, as the one-macroblock-per-block kernel of the first port gave
# it (NVIDIA H100 80GB HBM3): the strip kernel keeps that kernel's
# summation order, so it must reproduce these bits, not only meet the
# plain version's tie contract
K1_HASHES = {
    "noise":
        "d836b75a898df5ebd1269bde9aa447a4877bd3727382fdfbd7b9c4fdf23b1899",
    "noise+overlay":
        "352bd878b54cbf25c4d965fb9034ae5ad552b47cf08db7f77f8df6c0ac478187"}


def _hold_k1_hash(key, coefs) -> None:
    got = _coef_hash(coefs)
    print(f"front_end output hash ({key}): {got}", flush=True)
    _require(got == K1_HASHES[key],
             f"front_end ({key}) no longer reproduces the pinned output "
             f"{K1_HASHES[key]}")


# the redesigned kernels' times before the redesign (PERF.md section 6,
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
EARLIER_MS = (("front_end", "K1 front_end", 0.435),
              ("front_end_overlay", "K1 + overlay", 0.469),
              ("motion_search_mc", "K3 motion_search_mc", 0.200),
              ("motion_search_mc_blocks", "K6a 8x8 r=3", 0.0295),
              ("motion_search_mc_dygrid", "K6b dygrid", 0.200),
              ("pack_segments", "K2 pack_segments", 0.2471),
              ("pack_block_bits_fused", "K7 pack_block_bits_fused", 1.0465),
              ("motion_search_mc_hier", "K5 motion_search_mc_hier", 0.0680),
              ("chroma_mc", "K4 chroma_mc", 0.0075),
              ("pack_block_bits64", "K8a pack_block_bits64", 1.2077),
              ("pack_block_bits", "K8b pack_block_bits", 1.6292),
              ("motion_search_mc_wide", "K3 r=64 banded", 3.3744),
              ("motion_search_mc_blocks_wide", "K6a 8x8 r=64 banded", 1.0185),
              ("motion_search_mc_hier_wide", "K5 r=64 wide", 0.3396))


def run_source_check(dev):
    """Phase 11: the on-device source on the card against the CPU's."""
    import torch
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    for h, w, n in ((96, 160, 4), (PH, PW, 3), (2160, 3840, 2)):
        for start in (0, 37):
            card = gradient_ball_planes(h, w, n, start, device=dev)
            cpu = gradient_ball_planes(h, w, n, start, device="cpu")
            bad = [int((a.cpu() != b).sum()) for a, b in zip(card, cpu)]
            _require(not any(bad), f"gradient_ball_planes({h}, {w}, {n}, "
                     f"{start}) differs between the card and the CPU at "
                     f"{bad} values of (r, g, b)")
    print("gradient_ball_planes: card == CPU value for value at 96x160, "
          f"{PH}x{PW} and 2160x3840", flush=True)


def run_4k(dev, lib):
    """Phase 12: K1, K3 and one JPEG GOP at 2160x3840, and the burn-in
    element's prewarm. Returns the GOP's launch counts."""
    import numpy as np
    import torch
    from flutpu_torch.codec.jpeg import JpegEncoder
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.codec.ops import motion_kernels as M
    from flutpu_torch.codec.ops.colorspace import planes_to_i420
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    from flutpu_torch.core import Caps
    from flutpu_torch.ttml.render.composite import overlay_on_planes
    from flutpu_torch.ttml.render.overlay_el import OverlayCompositor

    h4, w4, f4 = 2160, 3840, 8
    enc = JpegEncoder(quality=QUALITY, device=dev)
    qy, qc = enc._qy_dev, enc._qc_dev
    rng = np.random.default_rng(12)
    noise = tuple(torch.from_numpy(rng.integers(0, 256, (2, h4, w4),
                                                np.uint8)).to(dev)
                  for _ in range(3))
    ov = rng.integers(0, 256, (h4, w4, 4), np.uint8)
    ov[:600, :, 3], ov[600:1200, :, 3], ov[1200:1700, :, 3] = 255, 128, 0
    ov = torch.from_numpy(ov).to(dev)
    _k1_compare(noise, qy, qc, "4K uniform-noise frames")
    got, _ = _k1_compare(noise, qy, qc, "4K uniform-noise frames + overlay",
                         overlay=ov)
    staged = F.front_end(*overlay_on_planes(*noise, ov), qy, qc)
    _require(all(torch.equal(a, b) for a, b in zip(got, staged)),
             "4K: K1 with an overlay differs from K1 on blended planes")
    del noise, got, staged
    src = gradient_ball_planes(h4, w4, f4, 0, device=dev)
    _k1_compare(src, qy, qc, "4K gradient-ball GOP")
    _k1_compare(src, qy, qc, "4K gradient-ball GOP + overlay", overlay=ov)
    ms = _time_ms(lambda: F.front_end(*src, qy, qc), 20)
    ms_ov = _time_ms(lambda: F.front_end(*src, qy, qc, overlay=ov), 20)
    plain_ms = _time_ms(lambda: F.front_end_plain(*src, qy, qc), 2)
    px = f4 * h4 * w4
    bound = _bound(3 * px + 2 * 1.5 * px)["bound_ms"]
    bound_ov = _bound(3 * px + 2 * 1.5 * px + h4 * w4 * 4)["bound_ms"]
    print(f"front_end at 4K: kernel {ms:.4f} ms (bound {bound:.4f}), with "
          f"an overlay {ms_ov:.4f} ms (bound {bound_ov:.4f}), plain "
          f"{plain_ms:.3f} ms per {f4}-frame 2160x3840 GOP", flush=True)

    y = planes_to_i420(*(p[:2] for p in src))[0]
    cur, prev = y[1].contiguous(), y[0].contiguous()
    r = SEARCH_RANGE
    _hold_search("4K gradient-ball frames 0->1", "motion_search_mc",
                 M.motion_search_mc(cur, prev, r),
                 M.motion_search_mc_plain(cur, prev, r), cur, prev, r, 16,
                 True, lambda p, m: M.motion_compensate(p, m, r))
    k3_ms = _time_ms(lambda: M.motion_search_mc(cur, prev, r), 20)
    k3_plain = _time_ms(lambda: M.motion_search_mc_plain(cur, prev, r), 2)
    print(f"motion_search_mc at 4K: kernel {k3_ms:.4f} ms (bound "
          f"{_search_bound(h4, w4, 16, r)['bound_ms']:.4f}), plain "
          f"{k3_plain:.3f} ms per 2160x3840 luma frame (r={r})", flush=True)
    del src, y, cur, prev, ov

    def source(ph, pw, start):
        return gradient_ball_planes(ph, pw, f4, start, device=dev)

    # one GOP first so the adaptive sizes are learned, as a stream would
    enc.encode_gop_finalize(enc.encode_gop_dispatch_src(source, 0, h4, w4,
                                                        h4, w4))
    t0 = time.perf_counter()
    (payloads, n) = _count_launches(lambda: enc.encode_gop_finalize(
        enc.encode_gop_dispatch_src(source, f4, h4, w4, h4, w4)))
    wall = time.perf_counter() - t0
    _require(n["front_end"] > 0 and n["pack_segments"] > 0,
             "K1 and K2 must launch on the 4K GOP")
    planes = source(h4, w4, f4)
    coefs = F.front_end(*planes, qy, qc)
    worst = _check_frames(lib, payloads, coefs, torch.stack(planes, dim=-1),
                          enc, "4K GOP", size=(h4, w4, h4, w4))
    print(f"4K JPEG GOP: {f4} frames in {wall:.3f} s, mean "
          f"{np.mean([len(p) for p in payloads]):.0f} bytes/frame; every "
          f"scan decodes to K1's coefficients and equals "
          f"flu_jpeg_encode_scan; lowest PSNR {worst:.2f} dB; kernel "
          f"launches {n}", flush=True)

    comp = OverlayCompositor(device=str(dev))
    t0 = time.perf_counter()
    warm = comp.prewarm(Caps.new("video/x-raw", width=w4, height=h4))
    _require(warm is True and comp.prewarm(None) is False
             and comp.prewarm(Caps.new("video/x-raw", width=w4)) is False,
             "cudaoverlaycompositor.prewarm")
    print(f"cudaoverlaycompositor.prewarm at 4K: True in "
          f"{time.perf_counter() - t0:.3f} s; False without caps or "
          "without a height", flush=True)
    torch.cuda.synchronize()
    return n


def _k1_compare(planes, qy, qc, label, overlay=None):
    """K1 against its plain version on ``planes`` (with ``overlay``): equal
    except ±1 on at most MAX_TIE_SHARE of the coefficients. Returns (the
    kernel's coefficients, max |difference|)."""
    import torch
    from flutpu_torch.codec.ops import frontend as F
    got = F.front_end(*planes, qy, qc, overlay=overlay)
    want = F.front_end_plain(*planes, qy, qc, overlay=overlay)
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
    kernels and copies; the five largest kernels, and K1 and the search
    kernel wherever they rank, as (name, ms per dispatch, launches per
    dispatch); device launches per dispatch,
    kernels and copies; every traced name with its launches per
    dispatch), or None where the profiler traced no device activity."""
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
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    # the five largest, and the redesigned kernels wherever they rank
    top = ranked[:5] + [kv for kv in ranked[5:]
                        if "front_end_kernel" in kv[0]
                        or "motion_search_mc_kernel" in kv[0]
                        or "motion_search_hier_kernel" in kv[0]
                        or "chroma_mc_kernel" in kv[0]]
    return (busy / 1e3 / n, [(k[:48], t / 1e3 / n, c / n)
                             for k, (t, c) in top], len(spans) / n,
            {k: c / n for k, (_, c) in per_name.items()})


def _call_launches(fn, dev, reps: int = 3):
    """Names of the device kernels and copies of one call of ``fn``
    (torch.profiler). The window holds three marks (fills of a complex
    tensor: no code of the port launches that kernel), then ``reps``
    calls, each followed by a mark; the launches between the last call's
    bracketing marks are the call's. The profiler has been seen to miss
    the first launch of a window, and to trace no device activity at all
    in some windows: a window that lacks any of its marks failed and is
    traced again, up to five times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mark = torch.empty(1, dtype=torch.complex64, device=dev)
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                mark.fill_(1)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
                mark.fill_(1)
                torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events)
                 if "Fill" in e.name and "complex" in e.name]
        if len(marks) == 3 + reps:
            return [e.name[:48] for e in events[marks[-2] + 1:marks[-1]]]
        print(f"torch.profiler traced {len(marks)} of the window's "
              f"{3 + reps} marks; tracing the call again", flush=True)
    raise RuntimeError("chip_smoke: torch.profiler lost device activity in "
                       "five windows")


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


def _slot_bytes(lens):
    """K8a's or K8b's bytes in: 4 per length up to each block's last
    active slot, and 4 per value word the kernel reads: lo where the
    length is not 0, hi too where it exceeds 32 (K8b's tables have no
    length above 32)."""
    import torch
    pos = torch.arange(1, lens.shape[1] + 1, device=lens.device)
    last = torch.where(lens > 0, pos, 0).amax(dim=1)
    return 4 * (int(last.sum()) + int((lens > 0).sum())
                + int((lens > 32).sum()))


def run_block_packs(coefs, coefs_n, layout):
    """Phase 2b: K7, K8a and K8b on the gradient-ball and uniform-noise
    GOPs' MCU blocks (K8a on ``_slot_tables_merged``, K8b on
    ``_slot_tables``), each bit-identical to its plain version and the
    three to each other, each timed beside its bound. K8a's and K8b's
    bytes follow the data (``_slot_bytes``), plus each block's 64 words
    and count out. Returns the kernels' results of the gradient-ball
    GOP."""
    import torch
    from flutpu_torch.codec.ops import entropy_kernels as K
    from flutpu_torch.codec.ops.entropy import (_mcu_blocks, _slot_tables,
                                                _slot_tables_merged)

    def blocks(c):
        mcu, comp = _mcu_blocks(*c, layout)
        return mcu.reshape(-1, 64), comp.repeat(mcu.shape[0])

    results = {}
    for gop, c in (("gradient-ball", coefs), ("uniform-noise", coefs_n)):
        zz, comp = blocks(c)
        n = zz.shape[0]
        out_bytes = n * (K.BLOCK_WORDS + 1) * 4
        cases = {"pack_block_bits_fused": (
                     K.pack_block_bits_fused, K.pack_block_bits_fused_plain,
                     (zz, comp), n * (64 + 1) * 4)}
        for name, kernel, plain, tables in (
                ("pack_block_bits64", K.pack_block_bits64,
                 K.pack_block_bits64_plain, _slot_tables_merged),
                ("pack_block_bits", K.pack_block_bits,
                 K.pack_block_bits_plain, _slot_tables)):
            args = tables(zz, comp)
            cases[name] = (kernel, plain, args, _slot_bytes(args[0]))
        outs = []
        for name, (kernel, plain, args, in_bytes) in cases.items():
            got, want = kernel(*args), plain(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"{name} vs plain ({gop} GOP, {n} blocks): "
                  f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
            _require(same, f"{name} differs from its plain version on the "
                     f"{gop} GOP")
            outs.append(got)
            bound = _bound(in_bytes + out_bytes)
            ms = _time_ms(lambda: kernel(*args), 20)
            mb = (in_bytes + out_bytes) / 1e6
            print(f"{name} ({gop} GOP): kernel {ms:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({mb:.1f} MB, "
                  f"{ms / bound['bound_ms']:.1f}x)", flush=True)
            if gop == "gradient-ball":
                plain_ms = _time_ms(lambda: plain(*args), 3)
                print(f"{name}: plain {plain_ms:.3f} ms per 16-frame 1080p "
                      "GOP", flush=True)
                results[name] = dict(max_abs_err=max(
                    int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                    for a, b in zip(got, want)), ms=ms, plain_ms=plain_ms,
                    **bound)
        same = all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(o, outs[0]))
        print(f"K7, K8a, K8b against each other ({gop} GOP): "
              f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
        _require(same, f"the three block packs disagree on the {gop} GOP")
        del zz, comp, cases, outs, got, want
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
        busy, top = got[:2]
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
    """Phase 5: K3 and K4 against their plain versions at 1080p, and their
    times. Returns the kernels' results."""
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
    for rr in (7, 5, 32):
        cb, cr = (torch.from_numpy(rng.normal(128, 30, (PH // 2, PW // 2))
                                   .astype(np.float32)).to(dev)
                  for _ in range(2))
        mv = torch.from_numpy(rng.integers(-rr, rr + 1,
                                           (PH // 16, PW // 16, 2))
                              .astype(np.int32)).to(dev)
        got = M.chroma_mc(cb, cr, mv, rr)
        want = M.chroma_mc_plain(cb, cr, mv, rr)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        odd = int(((mv < 0) & (mv % 2 == 1)).sum())
        print(f"chroma_mc vs plain (r={rr}, random vectors, {odd} odd "
              f"negative components): "
              f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
        _require(same, f"chroma_mc differs from its plain version at r={rr}")
        k4_err = max(k4_err, *(float((a - b).abs().max())
                               for a, b in zip(got, want)))
        if rr == SEARCH_RANGE:
            timed = (cb, cr, mv)
    cb, cr, mv = timed
    k4_ms = _time_ms(lambda: M.chroma_mc(cb, cr, mv, SEARCH_RANGE), 50)
    k4_plain_ms = _time_ms(
        lambda: M.chroma_mc_plain(cb, cr, mv, SEARCH_RANGE), 10)
    print(f"chroma_mc: kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms per "
          f"pair of 544x960 chroma planes (r={SEARCH_RANGE})", flush=True)
    torch.cuda.synchronize()
    return ({"motion_search_mc": dict(max_abs_err=err, ms=k3_ms,
                                      plain_ms=k3_plain_ms,
                                      **_search_bound(PH, PW, 16, r)),
             "chroma_mc": dict(max_abs_err=k4_err, ms=k4_ms,
                               plain_ms=k4_plain_ms,
                               **_bound(4 * (PH // 2) * (PW // 2) * 4
                                        + (PH // 16) * (PW // 16) * 2 * 4))})


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
    import torch
    (mv, pred), (mv_p, _) = got, plain
    # bit patterns: a NaN of prev is copied, not computed
    _require(torch.equal(pred.view(torch.int32),
                         compensate(prev, mv).view(torch.int32)),
             f"{name} ({label}): prediction differs from the compensation "
             "of its vectors")
    d = 0.0
    ties = _near_tie_check(cur, prev, mv, mv_p, r, mb, bias)
    print(f"{name} vs plain ({label}): {ties} of {mv.shape[0] * mv.shape[1]}"
          f" blocks differ, each a float64-verified near-tie; prediction "
          "exact", flush=True)
    return d


#: K5's search ranges in phase 5b (the encoder's default is 7)
HIER_RANGES = (1, 2, 3, 7, 16, 32)


def _hier_pairs(pairs, dev):
    """The K3 pairs, a flat pair (every refine candidate ties) and a pair
    with NaN: the first macroblock row of cur (every cost NaN: vector
    (0, 0)) and one pixel of prev (the candidates that read it never
    win)."""
    import torch
    flat = torch.full((PH, PW), 100.0, device=dev)
    cur, prev = pairs[0][1].clone(), pairs[0][2].clone()
    cur[:16] = float("nan")
    prev[500, 700] = float("nan")
    return pairs + [("flat", flat, flat), ("NaN", cur, prev)]


def run_hier_kernels(dev):
    """Phase 5b: K6a (8x8 blocks on the pooled 544x960 planes at r=3,
    16x16 on 1088x1920 at r=7), K5 (the whole hier search in one launch)
    and K6b against their plain versions, and their times. K5 runs at
    every range of HIER_RANGES on the K3 pairs, a flat pair and a pair
    with NaN, and one call of it is one device launch (torch.profiler).
    Returns the kernels' results."""
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
    for rr in HIER_RANGES:
        for label, cur, prev in _hier_pairs(pairs, dev):
            got = M.motion_search_mc_hier(cur, prev, rr)
            err["hier"] = max(err["hier"], _hold_search(
                f"{label}, r={rr}", "motion_search_mc_hier", got,
                M.motion_search_mc_hier_plain(cur, prev, rr), cur, prev, rr,
                16, False, lambda p, m: M.motion_compensate(p, m, rr)))
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
         "hier": _time_ms(lambda: M.motion_search_mc_hier(cur, prev, r), 20),
         "hier_plain": _time_ms(lambda: M.motion_search_mc_hier_plain(
             cur, prev, r), 3),
         "dygrid": (_time_ms(lambda: M.motion_search_mc_dygrid(
             cur, prev, r), 20), _time_ms(
             lambda: M.motion_search_mc_dygrid_plain(cur, prev, r), 3))}
    names = _call_launches(lambda: M.motion_search_mc_hier(cur, prev, r), dev)
    print(f"motion_search_mc_hier, one call (torch.profiler): {len(names)} "
          f"device launches: {names}", flush=True)
    _require(len(names) == 1 and "motion_search_hier_kernel" in names[0],
             f"a call of K5 is not one launch of its kernel: {names}")
    print(f"motion_search_mc_blocks: kernel {t['blocks8'][0]:.4f} ms, plain "
          f"{t['blocks8'][1]:.3f} ms per pooled 544x960 plane (8x8, r={rc}); "
          f"kernel {t['blocks16'][0]:.4f} ms, plain {t['blocks16'][1]:.3f} ms "
          f"per 1088x1920 plane (16x16, r={r})", flush=True)
    print(f"motion_search_mc_hier: kernel {t['hier']:.4f} ms (one launch), "
          f"plain {t['hier_plain']:.3f} ms per 1088x1920 luma frame "
          f"(r={r})", flush=True)
    print(f"motion_search_mc_dygrid: kernel {t['dygrid'][0]:.4f} ms, plain "
          f"{t['dygrid'][1]:.3f} ms per 1088x1920 luma frame (r={r})",
          flush=True)
    # K6a on the hier path ran at 8x8 on the pooled planes until K5 took
    # its search into its own kernel: its record keeps that shape's times
    out["motion_search_mc_blocks"] = dict(
        max_abs_err=err["blocks"], ms=t["blocks8"][0],
        plain_ms=t["blocks8"][1], **_search_bound(PH // 2, PW // 2, 8, rc))
    # the whole hier call: the 8x8 coarse search on the pooled planes (its
    # ops; the pooled planes are intermediates) and the 9-candidate refine
    # over the full planes, which read cur and prev and write the
    # prediction and vectors
    coarse_ops = (PH // 2) * (PW // 2) * (2 * rc + 1) ** 2 * 3
    out["motion_search_mc_hier"] = dict(
        max_abs_err=err["hier"], ms=t["hier"], plain_ms=t["hier_plain"],
        **_search_bound(PH, PW, 16, 1, coarse_ops + 2 * PH * PW))
    out["motion_search_mc_dygrid"] = dict(
        max_abs_err=err["dygrid"], ms=t["dygrid"][0],
        plain_ms=t["dygrid"][1], **_search_bound(PH, PW, 16, r))
    return out


def _psnr(a, b) -> float:
    import numpy as np
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _check_chunks(lib, chunks, sources, label, size=(H, W),
                  cpu_decode=True):
    """Phase 7 for a list of chunks and their (F, H, W, 3) uint8 source
    frames (numpy): decode on the card, PSNR, scans against the native
    encoder (at the coded size the header gives), and with
    ``cpu_decode`` the first chunk's decode on the CPU against the
    card's (a 1080p chunk's CPU decode takes about a second). ``size``:
    the frame size the headers must give. Returns (lowest PSNR, max
    |dRGB|, max dPSNR)."""
    import numpy as np
    from flutpu_torch.codec.decode import decode_scan_to_coefs
    from flutpu_torch.codec.fvc import FvcDecoder
    card, cpu = FvcDecoder("cuda"), FvcDecoder("cpu")
    worst, d_rgb, d_psnr = float("inf"), 0, 0.0
    for ci, (data, src) in enumerate(zip(chunks, sources)):
        hdr, frames = FvcDecoder.parse_chunk(data)
        _require((hdr["height"], hdr["width"]) == tuple(size),
                 f"{label} chunk {ci}: header size")
        ph, pw = hdr["coded_height"], hdr["coded_width"]
        for fi, (_, _, payload) in enumerate(frames):
            coefs = decode_scan_to_coefs(payload, pw // 8, ph // 8, pw // 16,
                                         ph // 16, True)
            _require(coefs is not None,
                     f"{label} chunk {ci} frame {fi}: scan does not decode")
            _require(_native_scan(lib, *coefs) == payload,
                     f"{label} chunk {ci} frame {fi}: scan differs from "
                     "flu_jpeg_encode_scan of its coefficients")
        rgb, info = card.decode_chunk(data)
        _require(rgb.shape == src.shape, f"{label}: decoded shape "
                 f"{rgb.shape}")
        worst = min([worst] + [_psnr(a, s) for a, s in zip(rgb, src)])
        if ci or not cpu_decode:
            continue
        rgb_cpu, info_cpu = cpu.decode_chunk(data)
        _require(info["types"] == info_cpu["types"], f"{label}: types")
        d_rgb = int(np.abs(rgb.astype(np.int32)
                           - rgb_cpu.astype(np.int32)).max())
        d_psnr = max(abs(_psnr(a, s) - _psnr(b, s))
                     for a, b, s in zip(rgb, rgb_cpu, src))
    _require(worst >= MIN_PSNR, f"{label}: PSNR {worst:.2f} dB")
    # K9 rebuilds the planes in the CPU's order: the frames are the CPU's
    _require(d_rgb == 0, f"{label}: the card's decode differs from the "
             f"CPU's by up to {d_rgb} levels ({d_psnr:.4f} dB)")
    return worst, d_rgb, d_psnr


def _count_launches(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before
    and read just after; returns (fn's result, counts)."""
    import torch
    from flutpu_torch.codec.ops import entropy_kernels as K
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.codec.ops import motion_kernels as M
    from flutpu_torch.codec.ops import transform_kernels as T
    wrappers = {"front_end": F.front_end, "pack_segments": K.pack_segments,
                "pack_block_bits_fused": K.pack_block_bits_fused,
                "pack_block_bits64": K.pack_block_bits64,
                "pack_block_bits": K.pack_block_bits,
                "motion_search_mc": M.motion_search_mc,
                "chroma_mc": M.chroma_mc,
                "motion_search_mc_hier": M.motion_search_mc_hier,
                "motion_search_mc_blocks": M.motion_search_mc_blocks,
                "motion_search_mc_dygrid": M.motion_search_mc_dygrid,
                "block_dct": T.block_dct, "block_idct": T.block_idct}
    wide = (M.motion_search_mc, M.motion_search_mc_hier,
            M.motion_search_mc_blocks)
    torch.cuda.synchronize()
    for w_ in wrappers.values():
        w_.launches = 0
    F.front_end.overlay_launches = 0
    for w_ in wide:
        w_.wide_launches = 0
    out = fn()
    counts = {k: w_.launches for k, w_ in wrappers.items()}
    # K1's launches that ran its overlay branch (a share of front_end's)
    counts["front_end_overlay"] = F.front_end.overlay_launches
    # the searches' launches above r = 32 (a share of each one's)
    for w_ in wide:
        counts[w_.__name__ + "_wide"] = w_.wide_launches
    return out, counts


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
    for name in ("pack_segments", "motion_search_mc", "chroma_mc",
                 "block_dct", "block_idct"):
        _require(n_motion[name] > 0, f"{name} was not launched on the FVC "
                 "motion path")

    _print_busy("FVC full-search P chunk", enc, src)

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
    # K5 is one launch: K6a no longer runs on this path
    for name in ("motion_search_mc_hier", "chroma_mc", "pack_segments",
                 "block_dct", "block_idct"):
        _require(n[name] > 0, f"{name} was not launched on the hier+B path")
    for k, v in n.items():
        total[k] = total.get(k, 0) + v
    checks = [("FVC hier+B", chunks, sources(N_CHUNKS), True)]
    first = chunks[0]
    _print_busy("FVC hier+B chunk", enc, src)

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
        if kw == dict(hier=True):
            _print_busy(f"{label} chunk", enc, src)

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
    print(f"card vs CPU encode (544x960 hier+B chunk): "
          f"{'byte-identical' if a == b else 'DIFFERENT'} ({len(a)} vs "
          f"{len(b)} bytes)", flush=True)
    _require(a == b, "the card's 544x960 hier+B chunk differs from the CPU's")
    return total, first


#: the per-chunk encoder's device busy ms, launches per chunk and every
#: traced name's launches per chunk, by label (phases 6 and 8), for
#: phase 13's cudahype lines and phase 19
PER_CHUNK_BUSY = {}


def _print_busy(label, enc, src):
    """Device busy ms and launches per chunk of ``enc`` over 4 chunks of
    the on-device source (torch.profiler)."""
    got = _device_busy(lambda: _chunks_in_flight(enc, src, 4), 4)
    if got is not None:
        PER_CHUNK_BUSY[label] = (got[0], got[2], got[3])
    if got is None:
        print(f"device busy ({label}): not measured (the profiler traced no "
              "device activity)", flush=True)
        return
    print(f"device busy ({label}, torch.profiler, 4 chunks): {got[0]:.3f} ms "
          f"per chunk, {got[2]:g} device launches per chunk; largest kernels "
          "per chunk: " + "; ".join(f"{k} {t:.3f} ms x{c:g}"
                                    for k, t, c in got[1]), flush=True)


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


BURNIN_DOC = (
    "<?xml version='1.0'?><tt xmlns='http://www.w3.org/ns/ttml'>"
    "<body><div><p begin='0s' end='60s'>Burn-in subtitle</p></div>"
    "</body></tt>")
# 5 intervals; an outline with a blur, a region opacity, a fractional
# background alpha
BATCH_DOC = """<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="r" tts:origin="5% 70%" tts:extent="90% 25%"
            tts:backgroundColor="#00000080" tts:opacity="0.7"/>
  </layout></head>
  <body><div>
    <p begin="0s" end="1s" region="r" tts:color="white">first cue</p>
    <p begin="1s" end="2s" region="r" tts:color="yellow">second cue</p>
    <p begin="3s" end="4s" region="r"
       tts:textOutline="black 3px 2px">fourth, after a gap</p>
  </div></body>
</tt>"""
# the pipeline's document: the subtitle ends before the last frames do
PIPE_DOC = BURNIN_DOC.replace("60s", "0.5s")


def _render(doc, props):
    """``doc`` through ``cudattmlrender`` with ``props`` → every output
    buffer's (pts, duration, data)."""
    from flutpu_torch.core import Buffer, Harness
    h = Harness(f"cudattmlrender {props}")
    h.set_src_caps("application/ttml+xml")
    h.push(Buffer(doc.encode(), pts=0))
    h.push_eos()
    out = []
    while (b := h.pull(timeout=60)) is not None:
        out.append((b.pts, b.duration, b.data))
    h.teardown()
    return out


def _same_windows(a, b, label):
    """Two renders of one document: the same intervals, equal pixel for
    pixel (tensors or numpy). Returns the count of lit pixels."""
    import numpy as np
    import torch
    _require(len(a) == len(b) and a, f"{label}: {len(a)} vs {len(b)} "
             "intervals")
    lit = 0
    for i, ((pa, da, fa), (pb, db, fb)) in enumerate(zip(a, b)):
        fa, fb = (f.cpu().numpy() if isinstance(f, torch.Tensor) else f
                  for f in (fa, fb))
        _require((pa, da) == (pb, db), f"{label}: interval {i} timing")
        bad = np.argwhere(fa != fb)
        _require(not len(bad), f"{label}: interval {i} differs at "
                 f"{bad[:3].tolist()} ({len(bad)} values)")
        lit += int((fa[..., 3] > 0).sum())
    return lit


def run_burnin(dev, lib, k1_ms):
    """Phase 10: K1's overlay branch, the renderer, the burn-in main path
    and the burn-in pipeline. ``k1_ms``: phase 2's time of K1 without an
    overlay. Returns (K1-with-overlay's record, the launch counts of the
    main path and the pipeline)."""
    import numpy as np
    import torch
    from flutpu_torch.codec.decode import coefs_to_rgb
    from flutpu_torch.codec.jpeg import JpegEncoder, _edge_pad
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    from flutpu_torch.core import Buffer, parse_launch
    from flutpu_torch.core.elements import make_test_frame
    from flutpu_torch.ttml.render.composite import (overlay_on_frames,
                                                    overlay_on_planes)
    from flutpu_torch.ttml.render.fonts import font_backend

    enc = JpegEncoder(quality=QUALITY, device=dev)
    qy, qc = enc._qy_dev, enc._qc_dev

    # -- 10a. K1 with its overlay branch --------------------------------------
    src = gradient_ball_planes(PH, PW, GOP, 0, device=dev)
    rng = np.random.default_rng(5)
    ov = _seeded_overlay(dev, rng)
    got, err = _k1_compare(src, qy, qc, "gradient-ball GOP + seeded overlay",
                           overlay=ov)
    full = ov.new_zeros((PH, PW, 4))
    full[:H] = ov
    staged = F.front_end(*overlay_on_planes(*src, full), qy, qc)
    same = all(torch.equal(a, b) for a, b in zip(got, staged))
    none = F.front_end(*src, qy, qc)
    zero = all(torch.equal(a, b) for a, b in zip(
        F.front_end(*src, qy, qc, overlay=torch.zeros_like(ov)), none))
    changed = sum(int((a != b).sum()) for a, b in zip(got, none))
    print(f"front_end(overlay) vs front_end on planes blended beforehand: "
          f"{'bit-identical' if same else 'DIFFERENT'}; alpha-0 overlay vs "
          f"no overlay: {'bit-identical' if zero else 'DIFFERENT'}; the "
          f"overlay changes {changed} coefficients", flush=True)
    _require(same, "K1 with an overlay differs from K1 on blended planes")
    _require(zero, "K1 with an alpha-0 overlay differs from K1 without one")
    _require(changed > 0, "the overlay changed nothing")
    t_none = [_time_ms(lambda: F.front_end(*src, qy, qc), 20)]
    t_ov = [_time_ms(lambda: F.front_end(*src, qy, qc, overlay=ov), 20)
            for _ in range(2)]
    t_none.append(_time_ms(lambda: F.front_end(*src, qy, qc), 20))
    plain_ms = _time_ms(lambda: F.front_end_plain(*src, qy, qc, overlay=ov),
                        5)
    px = GOP * PH * PW
    # as K1, plus the overlay's 4 bytes per pixel read once for the whole
    # GOP, and per pixel a division and 3 x (2 products, 2 sums, a clip
    # and a floor)
    bound = _bound(3 * px + 2 * 1.5 * px + H * W * 4,
                   px * (17 + 1.5 * 35 + 19))
    print(f"front_end(overlay): kernel {t_ov[0]:.4f}, {t_ov[1]:.4f} ms, "
          f"without an overlay {t_none[0]:.4f}, {t_none[1]:.4f} ms in the "
          f"same loop (phase 2: {k1_ms:.4f}), plain {plain_ms:.3f} ms per "
          f"16-frame 1080p GOP; bound {bound['bound_ms']:.4f} ms",
          flush=True)
    record = dict(max_abs_err=err, ms=min(t_ov), plain_ms=plain_ms, **bound)
    del src, got, staged, none, full, ov

    # -- 10b. the renderer ------------------------------------------------------
    print(f"font backend: {font_backend()}", flush=True)
    size = f"window-width={PW} window-height={PH}"
    t0 = time.perf_counter()
    card = _render(BURNIN_DOC, f"{size} device-out=true device={dev}")
    t_card = time.perf_counter() - t0
    cpu = _render(BURNIN_DOC, f"{size} device=cpu")
    window = card[0][2]
    _require(isinstance(window, torch.Tensor) and window.is_cuda
             and tuple(window.shape) == (PH, PW, 4),
             "device-out did not hand over a tensor on the card")
    lit = _same_windows(card, cpu, "config-5 document, card vs CPU")
    _require(lit > 500, f"the rendered window is blank ({lit} lit pixels)")
    ys, xs = np.nonzero(cpu[0][2][..., 3])
    box = (int(ys.min()), int(ys.max()) + 1, int(xs.min()), int(xs.max()) + 1)
    print(f"render (config-5 document, {PW}x{PH}): card == CPU pixel for "
          f"pixel; {lit} lit pixels in rows {box[0]}-{box[1]}, columns "
          f"{box[2]}-{box[3]}; first render {t_card:.3f} s", flush=True)
    got = _device_busy(lambda: _render(
        BURNIN_DOC, f"{size} device-out=true device={dev}"), 1)
    if got is None:
        print("compositor: not measured (the profiler traced no device "
              "activity)", flush=True)
    else:
        print(f"compositor (config-5 interval, batch path, atlas warm): "
              f"{got[2]:g} device launches, {got[0]:.3f} ms busy per "
              "interval (torch.profiler)", flush=True)
    small = "window-width=640 window-height=368"
    base = _render(BATCH_DOC, f"{small} device={dev}")
    _require(len(base) >= 4, f"batch document gave {len(base)} intervals")
    for label, props in (
            ("without crop-delivery", f"device={dev} crop-delivery=false"),
            ("per interval", f"device={dev} batch-intervals=false"),
            ("device-out", f"device={dev} device-out=true"),
            ("on the CPU", "device=cpu")):
        lit = _same_windows(_render(BATCH_DOC, f"{small} {props}"), base,
                            f"batch document {label}")
    got = _device_busy(lambda: _render(BATCH_DOC, f"{small} device={dev}"),
                       len(base))
    print(f"render (batch document, {len(base)} intervals, 640x368): "
          "batched with crop-delivery == without == per interval == "
          f"device-out == CPU; {lit} lit pixels"
          + ("" if got is None else
             f"; {got[2]:g} device launches, {got[0]:.3f} ms busy per "
             "interval"), flush=True)

    # seeded tiles and instance tables (random coverage, fractional
    # opacities, overlapping and clipped placements): where a rounding
    # difference between the card and the CPU would show first
    from flutpu_torch.ttml.render import atlas as A
    from flutpu_torch.ttml.render.device import composite_instances
    tiles = [np.full((A.TILE_H, A.TILE_W), 255, np.uint8)] + [
        rng.integers(0, 256, (A.TILE_H, A.TILE_W), np.uint8)
        for _ in range(3)]
    ints = np.zeros((16, 9), np.int32)
    cols = np.zeros((16, 4), np.float32)
    for i in range(12):
        ints[i] = (rng.integers(0, 4), rng.integers(-400, 640),
                   rng.integers(-100, 368), rng.integers(1, A.TILE_W + 1),
                   rng.integers(1, A.TILE_H + 1), rng.integers(-20, 320),
                   rng.integers(-20, 184), rng.integers(320, 670),
                   rng.integers(184, 400))
        cols[i] = (*rng.random(3), rng.choice([1.0, 0.5, rng.random()]))
    wins = [composite_instances(
        A.atlas_from_numpy(tiles, device=d).device_array(), ints, cols, 368,
        640).cpu() for d in (dev, "cpu")]
    same = torch.equal(*wins)
    print("compositor on seeded tiles and 12 instances (640x368), card vs "
          f"CPU: {'pixel-identical' if same else 'DIFFERENT'}; "
          f"{int((wins[1][..., 3] > 0).sum())} lit pixels", flush=True)
    _require(same, "the compositor on the card differs from the CPU's")

    # -- 10c. the main path -------------------------------------------------------
    def source(ph, pw, start):
        return gradient_ball_planes(ph, pw, GOP, start, device=dev)

    def loop(e, overlay, n=N_GOPS):
        return _in_flight(
            lambda gi: e.encode_gop_dispatch_src(source, gi * GOP, H, W, PH,
                                                 PW, overlay=overlay),
            e.encode_gop_finalize, n)

    # one GOP first so the adaptive sizes are learned, as a stream would
    loop(enc, window, 1)
    walls = {"plain": [loop(enc, None)[2]]}
    (payloads, dev_ms, wall), n = _count_launches(lambda: loop(enc, window))
    walls["burn-in"] = [wall, loop(enc, window)[2]]
    walls["plain"].append(loop(enc, None)[2])
    fps = {k: [N_GOPS * GOP / w_ for w_ in v] for k, v in walls.items()}
    print(f"burn-in main path: {N_GOPS} GOPs x {GOP} frames with overlay= "
          f"in {wall:.3f} s = {fps['burn-in'][0]:.1f} frames/s, again "
          f"{fps['burn-in'][1]:.1f}; the same loop without an overlay "
          f"{fps['plain'][0]:.1f} before, {fps['plain'][1]:.1f} after; "
          f"device span {dev_ms:.3f} ms per GOP (CUDA events); kernel "
          f"launches {n}", flush=True)
    _require(n["front_end_overlay"] > 0 and n["pack_segments"] > 0,
             "K1's overlay branch and K2 must launch on the burn-in path")
    _require(n["front_end_overlay"] == n["front_end"],
             "a GOP of the burn-in path ran K1 without its overlay")
    total = dict(n)

    blk = JpegEncoder(quality=QUALITY, segmented=False, device=dev)
    loop(blk, window, 1)
    (blk_payloads, _, blk_wall), n = _count_launches(
        lambda: loop(blk, window, 2))
    print(f"burn-in, segmented=False: 2 GOPs in {blk_wall:.3f} s; kernel "
          f"launches {n}", flush=True)
    _require(n["front_end_overlay"] > 0 and n["pack_block_bits_fused"] > 0
             and n["pack_segments"] == 0,
             "K1's overlay branch and K7 must launch on the non-segment "
             "burn-in path")
    _require(blk_payloads == payloads[:2],
             "burn-in GOPs differ between the layouts")
    for k, v in n.items():
        total[k] += v

    window_cpu = window.cpu()
    ys, xs = np.nonzero(window_cpu.numpy()[:H, :W, 3] > 200)
    worst = float("inf")
    for gi in range(N_GOPS):
        planes = source(PH, PW, gi * GOP)
        coefs = F.front_end(*planes, qy, qc, overlay=window)
        frames = torch.stack(planes, dim=-1)[:, :H, :W]
        blended = overlay_on_frames(frames.cpu(), window_cpu[:H, :W]).to(dev)
        worst = min(worst, _check_frames(lib, payloads[gi], coefs, blended,
                                         enc, f"burn-in GOP {gi}"))
        if gi == 0:
            rgb = coefs_to_rgb(*coefs, qy, qc, H, W)[0].float().cpu()
            under = (rgb - frames[0].float().cpu()).abs()[ys, xs].mean()
            burnt = (rgb - blended[0].float().cpu()).abs()[ys, xs].mean()
            print(f"under the subtitle ({len(ys)} pixels of alpha > 200): "
                  f"decoded frame 0 is {float(burnt):.2f} levels from the "
                  f"blended source, {float(under):.2f} from the unblended",
                  flush=True)
            _require(len(ys) > 200 and under > 4 * burnt and under > 8,
                     "the decoded frame does not carry the subtitle")
    print(f"checks (burn-in): {N_GOPS * GOP} frames decode to K1-with-"
          f"overlay's coefficients, equal flu_jpeg_encode_scan; lowest PSNR "
          f"against the source blended on the CPU {worst:.2f} dB",
          flush=True)

    for key, label, overlay in (("plain", "plain JPEG", None),
                                ("burn-in", "burn-in", window)):
        got = _device_busy(lambda: loop(enc, overlay, 4), 4)
        if got is None:
            print(f"device busy ({label}): not measured (the profiler "
                  "traced no device activity)", flush=True)
            continue
        wall_ms = min(walls[key]) / N_GOPS * 1e3
        print(f"device busy ({label}, torch.profiler, 4 GOPs): "
              f"{got[0]:.3f} ms per GOP, {got[2]:g} launches per GOP; busy "
              f"share {got[0] / wall_ms:.3f} of {wall_ms:.2f} ms wall per "
              "GOP (the faster 8-GOP loop); largest kernels per GOP: "
              + "; ".join(f"{k} {t:.3f} ms x{c:g}" for k, t, c in got[1]),
              flush=True)

    # -- 10d. the pipeline ----------------------------------------------------------
    def pipeline():
        pipe = parse_launch(
            f"videotestsrc num-buffers={PIPE_FRAMES} pattern=gradient "
            f"width={W} height={H} ! comp.video "
            "appsrc name=ssrc caps='application/ttml+xml' "
            f"! cudattmlrender window-width={W} window-height={H} "
            "device-out=true ! comp.overlay "
            f"cudaoverlaycompositor name=comp ! cudajpegenc "
            f"batch-frames={GOP} ! appsink name=out")
        ssrc, sink = pipe.get_by_name("ssrc"), pipe.get_by_name("out")
        # the document first: the renderer runs in this thread, so its
        # window waits in the compositor when the first frame arrives
        ssrc.push(Buffer(PIPE_DOC.encode(), pts=0))
        ssrc.end_of_stream()
        t0 = time.perf_counter()
        pipe.play()
        bufs = []
        try:
            while (buf := sink.try_pull_buffer(timeout=60)) is not None:
                bufs.append(buf)
        finally:
            pipe.stop()
        return bufs, time.perf_counter() - t0

    (bufs, pipe_wall), n = _count_launches(pipeline)
    print(f"burn-in pipeline: {len(bufs)} frames in {pipe_wall:.3f} s; "
          f"kernel launches {n}", flush=True)
    _require(len(bufs) == PIPE_FRAMES, f"pipeline gave {len(bufs)} frames")
    _require([b.pts for b in bufs] == sorted(b.pts for b in bufs),
             "pipeline output out of order")
    _require(n["front_end"] > 0 and n["pack_segments"] > 0,
             "K1 and K2 must launch in the burn-in pipeline")
    for k, v in n.items():
        total[k] += v
    (_, _, pipe_window), = _render(
        PIPE_DOC, f"window-width={W} window-height={H} device=cpu")
    pipe_window = torch.from_numpy(pipe_window)
    stop = 0.5 * 1e9
    worst, n_sub = float("inf"), 0
    for g0 in range(0, PIPE_FRAMES, GOP):
        raw = torch.from_numpy(np.stack([
            make_test_frame("gradient", W, H, i)
            for i in range(g0, g0 + GOP)]))
        inside = torch.tensor([b.pts < stop for b in bufs[g0:g0 + GOP]],
                              dtype=torch.bool)
        n_sub += int(inside.sum())
        frames = torch.where(inside[:, None, None, None],
                             overlay_on_frames(raw, pipe_window), raw).to(dev)
        planes = [_edge_pad(frames[..., c], PH, PW) for c in range(3)]
        coefs = F.front_end(*planes, qy, qc)
        worst = min(worst, _check_frames(
            lib, [b.data for b in bufs[g0:g0 + GOP]], coefs, frames, enc,
            f"burn-in pipeline frames {g0}-{g0 + GOP - 1}"))
    _require(0 < n_sub < PIPE_FRAMES, f"{n_sub} frames inside the subtitle")
    print(f"checks (burn-in pipeline): {PIPE_FRAMES} frames decode to K1's "
          f"coefficients of the frames blended on the CPU ({n_sub} inside "
          f"the subtitle's interval carry it, {PIPE_FRAMES - n_sub} after "
          f"it do not); lowest PSNR {worst:.2f} dB", flush=True)
    torch.cuda.synchronize()
    return record, total


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


# -- 13. GOP-chunk parallelism (BASELINE config 3) ------------------------------

HYPE_FRAMES = 300      # config 3: a 1080p30 clip of 10 s
HYPE_GOP = 30
HYPE_CHUNKS = 8
HYPE_BRANCHES = 4
FVC_HYPE_FRAMES = (64, 70)   # 70: a truncated tail of 6 frames
SWAP_W, SWAP_H, SWAP_FRAMES, SWAP_AT = 1280, 720, 60, 20
FRAME_NS = 33_333_333    # 30 frames/s
#: 13c's cudahype FVC output per launch string: (chunk bytes, source
#: frames (numpy)), read again by phase 14b
HYPE_FVC_STREAMS = {}


def _gradient_frames(dev, first: int, n: int):
    """``videotestsrc pattern=gradient`` frames first .. first + n - 1 at
    (H, W), built on ``dev``: frame 0's red and green ramps, blue (i * 5)
    mod 256 (``make_test_frame``'s values, without its per-frame host
    cost)."""
    import torch
    from flutpu_torch.core.elements import make_test_frame
    base = torch.from_numpy(make_test_frame("gradient", W, H, 0)).to(dev)
    out = base.expand(n, H, W, 3).clone()
    out[..., 2] = torch.tensor([(i * 5) % 256 for i in range(first,
                                                              first + n)],
                               dtype=torch.uint8, device=dev)[:, None, None]
    return out


def _union_ms(spans) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def _traced(fn):
    """Run ``fn`` under torch.profiler → (fn's result, (device busy ms:
    the union of traced device intervals, and of its kernels alone, the
    copies left out; the six largest device items as (name, ms,
    launches)), device launches), busy None where the profiler traced no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return out, None, 0
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    kernels = [(e.time_range.start, e.time_range.end) for e in events
               if not e.name.startswith(("Memcpy", "Memset"))]
    per_name = {}
    for e in events:
        t, c = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    return out, (_union_ms(spans), _union_ms(kernels), top), len(events)


def _harness_run(desc, frames, caps, warm=None, trace=0):
    """Push ``frames`` (numpy) through the element ``desc`` in a Harness
    (the chain runs in this thread) and pull everything → (buffers, wall
    seconds, (busy, launches, wall seconds) of ``_traced`` over the pushes
    of the first ``trace`` frames, or None). ``warm``: frames pushed first, their
    outputs drained before the clock and the trace start (a fresh encoder
    sizes its entropy stage on its first dispatch and redispatches once
    where the sizes fall short); the measured frames' pts follow the warm
    frames'."""
    from flutpu_torch.core import Buffer, Harness
    h = Harness(desc)
    h.set_src_caps(caps)
    first = 0
    if warm is not None:
        for i, f in enumerate(warm):
            h.push(Buffer(f, pts=i * FRAME_NS, duration=FRAME_NS, offset=i))
        try:
            while h.pull(timeout=0.5) is not None:
                pass
        except TimeoutError:   # drained: the warm outputs are out
            pass
        first = len(warm)

    def push(start, stop):
        for i in range(start, stop):
            h.push(Buffer(frames[i], pts=(first + i) * FRAME_NS,
                          duration=FRAME_NS, offset=first + i))

    t0 = time.perf_counter()
    traced = None
    if trace:
        _, busy, launches = _traced(lambda: push(0, trace))
        traced = (busy, launches, time.perf_counter() - t0)
    push(trace, len(frames))
    h.push_eos()
    out = []
    while (b := h.pull(timeout=120)) is not None:
        out.append(b)
    wall = time.perf_counter() - t0
    h.teardown()
    return out, wall, traced


def _report(label, n_frames, wall, busy, launches, n_chunks, peak,
            busy_wall=None):
    """One line of frames/s, peak memory, busy and launches per chunk;
    ``busy_wall``: the wall seconds the trace covered, where it covered
    a part of the run."""
    busy_txt = "busy not measured (the profiler traced no device activity)" \
        if busy is None else (f"device busy {busy[0] / n_chunks:.3f} ms per "
                              f"chunk (share "
                              f"{busy[0] / 1e3 / (busy_wall or wall):.3f}; "
                              f"kernels alone {busy[1] / n_chunks:.3f}, the "
                              "rest copies)")
    print(f"{label}: {n_frames} frames in {wall:.3f} s = "
          f"{n_frames / wall:.1f} frames/s; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; {busy_txt}, "
          f"{launches / n_chunks:g} device launches per chunk "
          f"(torch.profiler, {n_chunks} chunks)", flush=True)
    if busy is not None:
        print("  largest device items per chunk: " + "; ".join(
            f"{k[:48]} {t / n_chunks:.3f} ms x{c / n_chunks:g}"
            for k, (t, c) in busy[2]), flush=True)


def run_hype(dev, lib, lap, single_ms):
    """Phase 13: config 3 through the hype bin and cudahype, the FVC arms
    of cudahype, the injectbin swap, and K3, K5, K4 with a chunk axis.
    Returns the kernels' launch counts over the paths."""
    import torch
    from flutpu_torch.codec.jpeg import JpegEncoder, _edge_pad
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.core import parse_launch

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    caps = f"video/x-raw, format=RGB, width={W}, height={H}, framerate=30/1"
    n_gops = HYPE_FRAMES // HYPE_GOP
    enc = JpegEncoder(quality=QUALITY, device=dev)

    def pipeline(tail):
        torch.cuda.reset_peak_memory_stats()
        (bufs, wall), n = _count_launches(lambda: _pipeline(
            parse_launch, f"videotestsrc num-buffers={HYPE_FRAMES} "
            f"pattern=gradient width={W} height={H} ! {tail} "
            "! appsink name=out"))
        return bufs, wall, n, torch.cuda.max_memory_allocated()

    # -- 13a. the hype bin: four cudajpegenc branches on one card ---------
    branches = " ".join(f"encoder-{k}='cudajpegenc batch-frames=16 "
                        f"device={dev}'" for k in range(HYPE_BRANCHES))
    (bufs_a, wall, n, peak), busy, launches = _traced(
        lambda: pipeline(f"hype gop-size={HYPE_GOP} {branches}"))
    _report(f"13a hype gop-size={HYPE_GOP} {HYPE_BRANCHES} x cudajpegenc "
            "(videotestsrc 1080p, under the profiler)", HYPE_FRAMES, wall,
            busy, launches, n_gops, peak)
    print(f"13a kernel launches {n}", flush=True)
    _require(n["front_end"] > 0 and n["pack_segments"] > 0,
             "K1 and K2 must launch in the hype bin")
    add(n)
    _require(len(bufs_a) == HYPE_FRAMES,
             f"the hype bin gave {len(bufs_a)} frames")
    pts = [b.pts for b in bufs_a]
    _require(all(a < b for a, b in zip(pts, pts[1:])),
             "the hype bin's output is out of order")
    worst = float("inf")
    for g in range(n_gops):
        frames = _gradient_frames(dev, g * HYPE_GOP, HYPE_GOP)
        got = [bytes(b.data) for b in bufs_a[g * HYPE_GOP:(g + 1) * HYPE_GOP]]
        _require(got == enc.encode_gop(frames),
                 f"hype GOP {g} differs from a JpegEncoder encode")
        planes = [_edge_pad(frames[..., c], PH, PW) for c in range(3)]
        worst = min(worst, _check_frames(
            lib, got, F.front_end(*planes, enc._qy_dev, enc._qc_dev),
            frames, enc, f"hype GOP {g}", size=(H, W, PH, PW)))
    print(f"13a checks: {HYPE_FRAMES} frames in order (pts strictly "
          f"increasing), each byte-identical to a JpegEncoder encode, "
          f"decoding to K1's coefficients; lowest PSNR {worst:.2f} dB",
          flush=True)
    lap("13a hype bin")

    # -- 13b. cudahype: 8 chunks per dispatch -----------------------------
    (bufs_b, wall, n, peak), busy, launches = _traced(lambda: pipeline(
        f"cudahype codec=jpeg chunks={HYPE_CHUNKS} gop-size={HYPE_GOP} "
        f"device={dev}"))
    _report(f"13b cudahype codec=jpeg chunks={HYPE_CHUNKS} "
            f"gop-size={HYPE_GOP} (videotestsrc 1080p, under the profiler; "
            f"2 dispatches, the second padded)", HYPE_FRAMES, wall, busy,
            launches, n_gops, peak)
    print(f"13b kernel launches {n}", flush=True)
    _require(n["front_end"] > 0 and n["pack_segments"] > 0,
             "K1 and K2 must launch in cudahype")
    add(n)
    _require([b.pts for b in bufs_b] == pts,
             "cudahype's output order differs from the hype bin's")
    _require([bytes(b.data) for b in bufs_b]
             == [bytes(b.data) for b in bufs_a],
             "cudahype's JPEG bytes differ from the hype bin's")
    print(f"13b checks: {HYPE_FRAMES} frames in order, byte-identical to "
          "13a's (so each equals a JpegEncoder encode and decodes to K1's "
          "coefficients)", flush=True)
    # the element alone on frames already in host memory: one dispatch
    frames = _gradient_frames(dev, 0, HYPE_CHUNKS * HYPE_GOP).cpu().numpy()
    for label, desc in (
            ("hype bin", f"hype gop-size={HYPE_GOP} {branches}"),
            ("cudahype", f"cudahype codec=jpeg chunks={HYPE_CHUNKS} "
                         f"gop-size={HYPE_GOP} device={dev}")):
        torch.cuda.reset_peak_memory_stats()
        out, wall, _ = _harness_run(desc, frames, caps)
        _require([bytes(b.data) for b in out]
                 == [bytes(b.data) for b in bufs_a[:len(frames)]],
                 f"{label} on host frames differs from 13a")
        print(f"13b {label}, {len(frames)} frames pushed from host memory "
              f"(no source): {wall:.3f} s = {len(frames) / wall:.1f} "
              f"frames/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
    del frames, bufs_a, bufs_b
    lap("13b cudahype jpeg")

    add(_run_hype_fvc(dev, lib, caps))
    lap("13c cudahype fvc")
    _run_swap(dev)
    lap("13d injectbin swap")
    _batched_kernels(dev, single_ms)
    lap("13e batched K3, K5, K4")
    return total


def _run_hype_fvc(dev, lib, caps):
    """Phase 13c. Returns the launch counts."""
    import torch
    from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
    from flutpu_torch.codec.ops.testsrc import gradient_ball_frames

    total = {}
    for props, kw, n_frames, kernel in (
            ("", {}, FVC_HYPE_FRAMES[0], "motion_search_mc"),
            (" search=hier bframes=1", dict(hier=True, bframes=1),
             FVC_HYPE_FRAMES[1], "motion_search_mc_hier")):
        desc = (f"cudahype codec=fvc-motion chunks={HYPE_CHUNKS} "
                f"gop-size={CHUNK} search-range={SEARCH_RANGE} "
                f"device={dev}{props}")
        frames = gradient_ball_frames(PH, PW, n_frames, 0, device=dev)[
            :, :H, :W].cpu().numpy()
        # one dispatch first, as a stream would run: the element's first
        # dispatch sizes its entropy stage and may redispatch once
        warm = frames[:HYPE_CHUNKS * CHUNK]
        torch.cuda.reset_peak_memory_stats()
        (out, wall, (busy, launches, busy_wall)), n = _count_launches(
            lambda: _harness_run(desc, frames, caps, warm=warm,
                                 trace=len(warm)))
        peak = torch.cuda.max_memory_allocated()
        _require(n[kernel] > 0 and n["chroma_mc"] > 0
                 and n["pack_segments"] > 0,
                 f"{desc}: {kernel}, K4 and K2 must launch")
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        n_chunks = -(-n_frames // CHUNK)
        # busy and launches: the first dispatch of the measured frames
        _report(f"13c {desc} (after one warm dispatch; the trace over its "
                f"first {HYPE_CHUNKS}-chunk dispatch)", n_frames, wall, busy,
                launches, HYPE_CHUNKS, peak, busy_wall)
        was = PER_CHUNK_BUSY.get("FVC hier+B chunk" if kw else
                                 "FVC full-search P chunk")
        if was is not None:
            print(f"13c beside it, the per-chunk encoder on the on-device "
                  f"source (phase {8 if kw else 6}): {was[0]:.3f} ms busy, "
                  f"{was[1]:g} device launches per chunk", flush=True)
        print(f"13c kernel launches (warm dispatch included) {n}",
              flush=True)
        _require(len(out) == n_chunks, f"{desc}: {len(out)} chunks")
        _require([b.pts for b in out] == [(len(warm) + c * CHUNK) * FRAME_NS
                                          for c in range(n_chunks)],
                 f"{desc}: chunks out of order")
        ref = FvcEncoder(QUALITY, motion=True, search_range=SEARCH_RANGE,
                         device=dev, **kw)
        sources = []
        for ci, b in enumerate(out):
            src = frames[ci * CHUNK:(ci + 1) * CHUNK]
            sources.append(src)
            want = ref.encode_chunk(src)
            types = [t for t, _, _ in FvcDecoder.parse_chunk(b.data)[1]]
            # a B frame needs an anchor on each side: 3 frames or more
            _require((2 in types) == bool(kw.get("bframes") and len(src) > 2),
                     f"{desc} chunk {ci}: frame types {types}")
            _require_same(bytes(b.data), want, f"{desc} chunk {ci}")
        HYPE_FVC_STREAMS[desc] = ([bytes(b.data) for b in out], frames)
        worst, d_rgb, d_psnr = _check_chunks(lib, [bytes(b.data) for b in out],
                                             sources, f"13c {desc}")
        print(f"13c checks ({desc}): {len(out)} chunks in order, each "
              f"byte-identical to a per-chunk FvcEncoder on the card; decode "
              f"on the card at >= {worst:.2f} dB; scans equal "
              f"flu_jpeg_encode_scan; CPU decode max |dRGB| {d_rgb}, max "
              f"dPSNR {d_psnr:.4f} dB", flush=True)
    return total


def _run_swap(dev):
    """Phase 13d: a prewarmed cudajpegenc swapped into a running 720p
    stream; no buffer lost or reordered; the largest output gap."""
    import numpy as np
    from flutpu_torch.codec.jpeg import JpegEncoder
    from flutpu_torch.core import make, parse_launch
    from flutpu_torch.core.elements import make_test_frame
    p = parse_launch(f"videotestsrc num-buffers={SWAP_FRAMES} is-live=true "
                     f"pattern=ball width={SWAP_W} height={SWAP_H} "
                     "! injectbin name=ib ! appsink name=out")
    ib, sink = p.get_by_name("ib"), p.get_by_name("out")
    enc = make("cudajpegenc", batch_frames=1, device=str(dev))
    arrivals, bufs, swap_s = [], [], None
    p.play()
    try:
        while (buf := sink.try_pull_buffer(timeout=60)) is not None:
            arrivals.append(time.perf_counter())
            bufs.append(buf)
            if len(bufs) == SWAP_AT:
                t0 = time.perf_counter()
                ib.set_property("element", enc)   # prewarm, then the probe
                swap_s = time.perf_counter() - t0
    finally:
        p.stop()
    _require(len(bufs) == SWAP_FRAMES, f"the swap lost buffers: "
             f"{len(bufs)} of {SWAP_FRAMES}")
    pts = [b.pts for b in bufs]
    _require(all(a < b for a, b in zip(pts, pts[1:])),
             "the swap reordered buffers")
    jpeg = [isinstance(b.data, (bytes, bytearray))
            and bytes(b.data[:2]) == b"\xff\xd8" for b in bufs]
    first = jpeg.index(True)
    _require(all(jpeg[first:]) and not any(jpeg[:first]) and
             first >= SWAP_AT, f"raw frames then JPEG expected: {jpeg}")
    ref = JpegEncoder(QUALITY, device=dev)
    want = ref.encode_gop(np.stack([make_test_frame("ball", SWAP_W, SWAP_H, i)
                                    for i in range(first, SWAP_FRAMES)]))
    _require([bytes(b.data) for b in bufs[first:]] == want,
             "the swapped-in encoder's frames differ from a JpegEncoder's")
    gaps = np.diff(np.asarray(arrivals)) * 1e3
    print(f"13d injectbin swap (720p, live 30 frames/s): {SWAP_FRAMES} "
          f"buffers in order, none lost; raw before frame {first}, JPEG "
          f"from it on, equal to a JpegEncoder encode; set_property "
          f"(prewarm and probe) {swap_s * 1e3:.1f} ms on the caller's "
          f"thread; output gap median {float(np.median(gaps)):.1f} ms, "
          f"largest {float(gaps.max()):.1f} ms (at output "
          f"{int(gaps.argmax()) + 1})", flush=True)


def _batched_kernels(dev, single_ms):
    """Phase 13e: K3, K5 and K4 with a chunk axis at 1080p: one launch of
    8 chunks equal to each chunk's own launch (bit for bit) and to the
    plain version (K4 bit for bit; K3 and K5 but for float64-verified
    near-ties, predictions exact), timed beside 8 single launches."""
    import torch
    from flutpu_torch.codec.ops import motion_kernels as M
    from flutpu_torch.codec.ops.colorspace import planes_to_i420
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    c, r = HYPE_CHUNKS, SEARCH_RANGE
    y, cb, cr = planes_to_i420(*gradient_ball_planes(PH, PW, 2 * c, 0,
                                                     device=dev))
    cur, prev = y[1::2].contiguous(), y[0::2].contiguous()
    for name, kernel, plain, bias in (
            ("motion_search_mc", M.motion_search_mc,
             M.motion_search_mc_plain, True),
            ("motion_search_mc_hier", M.motion_search_mc_hier,
             M.motion_search_mc_hier_plain, False)):
        mv, pred = kernel(cur, prev, r)
        mv_p, _ = plain(cur, prev, r)
        for k in range(c):
            one = kernel(cur[k], prev[k], r)
            _require(torch.equal(mv[k], one[0]) and torch.equal(
                pred[k], one[1]), f"{name}: chunk {k} of a batched launch "
                "differs from its own launch")
            _hold_search(f"batched chunk {k}", name, (mv[k], pred[k]),
                         (mv_p[k], None), cur[k], prev[k], r, 16, bias,
                         lambda p_, m: M.motion_compensate(p_, m, r))
        _time_batched(name, lambda: kernel(cur, prev, r),
                      [lambda k=k: kernel(cur[k], prev[k], r)
                       for k in range(c)], c, single_ms[name])
    mv = M.motion_search_mc(cur, prev, r)[0]
    pcb, pcr = cb[0::2].contiguous(), cr[0::2].contiguous()
    got = M.chroma_mc(pcb, pcr, mv, r)
    _require(all(torch.equal(a, b) for a, b in zip(
        got, M.chroma_mc_plain(pcb, pcr, mv, r))),
        "chroma_mc (8 chunks) differs from its plain version")
    for k in range(c):
        one = M.chroma_mc(pcb[k], pcr[k], mv[k], r)
        _require(torch.equal(one[0], got[0][k]) and torch.equal(
            one[1], got[1][k]), f"chroma_mc: chunk {k} differs from its "
            "own launch")
    _time_batched("chroma_mc", lambda: M.chroma_mc(pcb, pcr, mv, r),
                  [lambda k=k: M.chroma_mc(pcb[k], pcr[k], mv[k], r)
                   for k in range(c)], c, single_ms["chroma_mc"])


def _time_batched(name, batched, singles, c, one_ms):
    """One launch of c chunks against c single launches, in turns (single,
    batched, batched, single); the singles get fewer repetitions, so that
    all their launches queue behind ``_time_ms``'s device sleep.
    ``one_ms``: the kernel's time per single launch from phase 5/5b."""
    def all_singles():
        for fn in singles:
            fn()
    reps = {all_singles: max(2, 40 // c), batched: 20}
    turns = [_time_ms(f, reps[f]) for f in (all_singles, batched, batched,
                                            all_singles)]
    print(f"{name} with a chunk axis: {c} chunks in one launch "
          f"{turns[1]:.4f}, {turns[2]:.4f} ms per frame step; {c} single "
          f"launches {turns[0]:.4f}, {turns[3]:.4f} ms (1080p; "
          f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x); {c} x "
          f"phase 5's single-launch time {c * one_ms:.4f} ms", flush=True)



# -- 14. the decode side: BASELINE config 2 as written, config 3 at contract
# scale, half-pel and 4:4:4 on the card, the coded-size extension ---------

DEC_W, DEC_H = 1280, 720      # config 2: 720p30
DEC_FRAMES, DEC_SWAP_AT = 90, 30
STREAM_BLOCK = 4096           # bytes per buffer of the FVC byte stream


def run_decode(dev, lib, lap):
    """Phase 14. Returns the kernels' launch counts over its paths."""
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    add(_run_config2(dev))
    lap("14a config 2")
    add(_run_config3_decode(dev))
    lap("14b config 3 decode")
    add(_run_subpel_444(dev, lib))
    lap("14c half-pel, 4:4:4")
    add(_run_coded_size(dev))
    lap("14d coded size")
    return total


def _decode_band_overlay(h, w):
    """Phase 14a's seeded (h, w, 4) BGRA window over the whole frame:
    noise colours in an opaque, a half-transparent and an alpha-0 band."""
    import numpy as np
    rng = np.random.default_rng(14)
    ov = rng.integers(0, 256, (h, w, 4), np.uint8)
    ov[: h // 3, :, 3], ov[h // 3: 2 * h // 3, :, 3] = 255, 128
    ov[2 * h // 3:, :, 3] = 0
    return ov


def _run_config2(dev):
    """Phase 14a: BASELINE config 2 as written. 90 frames of 720p
    ``videotestsrc pattern=ball`` encoded once by ``cudajpegenc``, the JFIF
    bytes in host memory; ``appsrc ! cudajpegdec ! injectbin ! appsink``
    fed live at 30 frames/s; at frame 30 a prewarmed
    ``cudaoverlaycompositor`` (its ``overlay`` pad fed beforehand: the
    bin links only the element's first sink pad) swapped in. Returns the
    launch counts of the encode that made the source (the decode path is
    plain PyTorch)."""
    import threading
    import numpy as np
    import torch
    from flutpu_torch.core import Buffer, make, parse_launch
    from flutpu_torch.core.elements import make_test_frame
    from flutpu_torch.ttml.render.composite import overlay_on_frames
    (bufs, enc_wall), n = _count_launches(lambda: _pipeline(
        parse_launch, f"videotestsrc num-buffers={DEC_FRAMES} pattern=ball "
        f"width={DEC_W} height={DEC_H} ! cudajpegenc batch-frames=16 "
        f"device={dev} ! appsink name=out"))
    jfif = [bytes(b.data) for b in bufs]
    _require(len(jfif) == DEC_FRAMES and n["front_end"] > 0
             and n["pack_segments"] > 0,
             f"14a source: {len(jfif)} frames, launches {n}")
    ov = _decode_band_overlay(DEC_H, DEC_W)
    comp = make("cudaoverlaycompositor", device=str(dev))
    _require(comp.overlay_pad.chain(Buffer(ov, pts=0)).name == "OK",
             "14a: the compositor refused its window")
    p = parse_launch(
        f"appsrc name=src caps='image/jpeg, width={DEC_W}, height={DEC_H}, "
        f"framerate=30/1' ! cudajpegdec device={dev} ! injectbin name=ib "
        "! appsink name=out")
    src, ib, sink = (p.get_by_name(k) for k in ("src", "ib", "out"))
    errors = []

    def feed():
        try:
            t0 = time.perf_counter()
            for i, data in enumerate(jfif):
                delay = t0 + i * FRAME_NS / 1e9 - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                src.push(Buffer(data, pts=i * FRAME_NS, duration=FRAME_NS,
                                offset=i))
        except Exception as e:   # reported by the checks below
            errors.append(repr(e))
        finally:
            src.end_of_stream()

    arrivals, out, swap_s = [], [], None
    p.play()
    feeder = threading.Thread(target=feed)
    feeder.start()
    try:
        while (buf := sink.try_pull_buffer(timeout=60)) is not None:
            arrivals.append(time.perf_counter())
            out.append(buf)
            if len(out) == DEC_SWAP_AT:
                t0 = time.perf_counter()
                ib.set_property("element", comp)   # prewarm, then the probe
                swap_s = time.perf_counter() - t0
    finally:
        feeder.join()
        p.stop()
    _require(not errors, f"14a feeder: {errors}")
    _require(len(out) == DEC_FRAMES,
             f"14a lost frames: {len(out)} of {DEC_FRAMES}")
    _require([b.pts for b in out] == [i * FRAME_NS
                                      for i in range(DEC_FRAMES)],
             "14a reordered frames")
    dec = make("cudajpegdec", device=str(dev))
    ov_t = torch.from_numpy(ov)
    first, worst, off_by_one = None, float("inf"), 0
    for i, (b, data) in enumerate(zip(out, jfif)):
        plain = dec.decode(data)
        got = np.asarray(b.data)
        worst = min(worst, _psnr(plain, make_test_frame("ball", DEC_W, DEC_H,
                                                        i)))
        if first is None and not np.array_equal(got, plain):
            first = i
        if first is None:
            continue
        want = overlay_on_frames(torch.from_numpy(plain)[None], ov_t)[0] \
            .numpy()
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        _require(int(d.max()) <= 1, f"14a frame {i}: differs by "
                 f"{int(d.max())} from the CPU blend of its decode")
        off_by_one += int((d > 0).sum())
    _require(first is not None and first >= DEC_SWAP_AT,
             f"14a: the swap took effect at frame {first}")
    _require(worst >= MIN_PSNR, f"14a: PSNR {worst:.2f} dB")
    gaps = np.diff(np.asarray(arrivals)) * 1e3
    print(f"14a config 2 (720p, {DEC_FRAMES} frames live at 30 frames/s, "
          f"JFIF from host memory ! cudajpegdec ! injectbin ! appsink): "
          f"none lost or reordered; frames 0-{first - 1} equal cudajpegdec's "
          f"plain decode, {first}-{DEC_FRAMES - 1} the CPU blend of it "
          f"(cudaoverlaycompositor swapped in at output {DEC_SWAP_AT}; "
          f"{off_by_one} values off by one); lowest PSNR {worst:.2f} dB; "
          f"set_property (prewarm and probe) {swap_s * 1e3:.1f} ms; output "
          f"gap median {float(np.median(gaps)):.1f} ms, largest "
          f"{float(gaps.max()):.1f} ms (at output {int(gaps.argmax()) + 1}); "
          f"source encode {enc_wall:.2f} s, launches {n}", flush=True)
    return n


def _run_config3_decode(dev):
    """Phase 14b: config 3 at contract scale (``cudahype`` → ``avimux`` →
    ``avidemux`` → ``cudajpegdec``, 300 frames of 1080p), then 13c's FVC
    chunks through ``decode_stream`` and ``cudafvcdec`` as a byte
    stream. Returns the launch counts."""
    import numpy as np
    import torch
    from flutpu_torch.codec.avimux import parse_avi
    from flutpu_torch.codec.fvc import FvcDecoder
    from flutpu_torch.core import Buffer, Harness, ProbeType, parse_launch
    p = parse_launch(
        f"videotestsrc num-buffers={HYPE_FRAMES} pattern=gradient width={W} "
        f"height={H} ! cudahype codec=jpeg chunks={HYPE_CHUNKS} "
        f"gop-size={HYPE_GOP} device={dev} ! avimux name=mux ! avidemux "
        f"name=demux ! cudajpegdec device={dev} ! appsink name=out")
    jfif, avi = [], []
    p.get_by_name("mux").sinkpad.add_probe(
        ProbeType.BUFFER, lambda pad, b: jfif.append(bytes(b.data)))
    p.get_by_name("demux").sinkpad.add_probe(
        ProbeType.BUFFER, lambda pad, b: avi.append(bytes(b.data)))
    sink = p.get_by_name("out")

    def play():
        t0 = time.perf_counter()
        p.play()
        got = []
        try:
            while (buf := sink.try_pull_buffer(timeout=120)) is not None:
                got.append(buf)
        finally:
            p.stop()
        return got, time.perf_counter() - t0

    (out, wall), n = _count_launches(play)
    _require(n["front_end"] > 0 and n["pack_segments"] > 0,
             f"14b: K1 and K2 must launch in cudahype ({n})")
    _require(len(out) == HYPE_FRAMES and len(jfif) == HYPE_FRAMES,
             f"14b: {len(out)} frames out, {len(jfif)} into avimux")
    pts = [b.pts for b in out]
    _require(all(a < b for a, b in zip(pts, pts[1:])), "14b: out of order")
    parsed = parse_avi(b"".join(avi))
    _require(parsed["frames"] == jfif and (parsed["width"],
                                           parsed["height"]) == (W, H),
             "14b: the AVI's frames differ from the JFIF entering avimux")
    worst = float("inf")
    for g in range(HYPE_FRAMES // HYPE_GOP):
        srcs = _gradient_frames(dev, g * HYPE_GOP, HYPE_GOP).float()
        got = torch.from_numpy(np.stack([np.asarray(b.data) for b in out[
            g * HYPE_GOP:(g + 1) * HYPE_GOP]])).to(dev).float()
        mse = ((got - srcs) ** 2).mean(dim=(1, 2, 3))
        psnr = 10 * torch.log10(255.0 ** 2 / mse.clamp(min=1e-12))
        worst = min(worst, float(psnr.min()))
    _require(worst >= MIN_PSNR, f"14b: PSNR {worst:.2f} dB")
    print(f"14b config 3: videotestsrc {HYPE_FRAMES} x 1080p ! cudahype "
          f"chunks={HYPE_CHUNKS} gop-size={HYPE_GOP} ! avimux ! avidemux ! "
          f"cudajpegdec: {HYPE_FRAMES} frames in order in {wall:.2f} s; the "
          f"AVI ({sum(map(len, avi))} bytes) holds the {len(jfif)} JFIF "
          "buffers that entered avimux byte for byte; lowest PSNR "
          f"{worst:.2f} dB (on the card); launches {n}", flush=True)
    first = [np.asarray(b.data) for b in out[:8]]
    del out
    # the decoder alone, from host memory, under the profiler
    caps = f"image/jpeg, width={W}, height={H}, framerate=30/1"
    dec_out, dwall, (busy, launches, busy_wall) = _harness_run(
        f"cudajpegdec device={dev}", jfif, caps, trace=len(jfif))
    _require(len(dec_out) == HYPE_FRAMES and all(
        np.array_equal(np.asarray(a.data), b)
        for a, b in zip(dec_out, first)), "14b: cudajpegdec alone differs")
    del dec_out
    print(f"14b cudajpegdec alone, {HYPE_FRAMES} frames from host memory in "
          f"{dwall:.3f} s = {HYPE_FRAMES / dwall:.1f} frames/s; " + _busy_line(
              HYPE_FRAMES, busy, launches, "frame", busy_wall), flush=True)
    card = FvcDecoder(dev)
    for desc, (chunks, frames) in HYPE_FVC_STREAMS.items():
        data = b"".join(chunks)
        got, busy, launches = _traced(lambda: card.decode_stream(data))
        t0 = time.perf_counter()
        got = card.decode_stream(data)
        swall = time.perf_counter() - t0
        want = np.concatenate([card.decode_chunk(c)[0] for c in chunks])
        _require(got.shape == frames.shape and np.array_equal(got, want),
                 f"14b {desc}: decode_stream differs from decode_chunk")
        del want
        h = Harness(f"cudafvcdec device={dev}")
        h.set_src_caps("video/x-fvc, framerate=30/1")
        t0 = time.perf_counter()
        for off in range(0, len(data), STREAM_BLOCK):
            h.push(Buffer(data[off:off + STREAM_BLOCK], pts=0))
        h.push_eos()
        el = []
        while (b := h.pull(timeout=120)) is not None:
            el.append(b)
        ewall = time.perf_counter() - t0
        h.teardown()
        _require(len(el) == got.shape[0] and all(
            np.array_equal(np.asarray(b.data), g) for b, g in zip(el, got)),
            f"14b {desc}: cudafvcdec in {STREAM_BLOCK}-byte blocks differs")
        _require([b.pts for b in el] == [i * FRAME_NS for i in range(len(el))],
                 f"14b {desc}: cudafvcdec pts")
        print(f"14b {len(chunks)} FVC chunks of 13c ({desc}), {len(data)} "
              f"bytes: decode_stream on the card = per-chunk decode_chunk "
              f"({got.shape[0] / swall:.1f} frames/s); cudafvcdec fed "
              f"{STREAM_BLOCK}-byte blocks: the same frames, pts "
              f"synthesized at 30 frames/s ({len(el) / ewall:.1f} frames/s); "
              "decode_stream " + _busy_line(got.shape[0], busy, launches,
                                            "frame", swall), flush=True)
        del got, el
    return n


def _busy_line(n, busy, launches, unit, wall=None):
    """``_traced``'s device busy time per ``unit`` (n of them), its share
    of ``wall`` seconds where given, launches and the largest items."""
    if busy is None:
        return "busy not measured (the profiler traced no device activity)"
    share = f"share {busy[0] / 1e3 / wall:.3f}; " if wall else ""
    return (f"device busy {busy[0] / n:.3f} ms per {unit} ({share}kernels "
            f"alone {busy[1] / n:.3f}, the rest copies), {launches / n:g} "
            f"device launches per {unit} (torch.profiler); largest: "
            + "; ".join(f"{k[:40]} {t / n:.3f} ms x{c / n:g}"
                        for k, (t, c) in busy[2][:4]))


def _element_frames(desc, chunks):
    """Each chunk as one buffer through the decoder element ``desc`` →
    the frames (numpy) in order."""
    import numpy as np
    from flutpu_torch.core import Buffer, Harness
    h = Harness(desc)
    h.set_src_caps("video/x-fvc, framerate=30/1")
    for ci, c in enumerate(chunks):
        h.push(Buffer(c, pts=ci * CHUNK * FRAME_NS,
                      duration=CHUNK * FRAME_NS))
    h.push_eos()
    out = []
    while (b := h.pull(timeout=120)) is not None:
        out.append(np.asarray(b.data))
    h.teardown()
    return np.stack(out)


def _run_subpel_444(dev, lib):
    """Phase 14c: half-pel FVC (full and hier search; ``cudahype
    subpel=true``) and 4:4:4 (a JPEG GOP, an FVC v1 chunk) on the card.
    Returns the launch counts."""
    import numpy as np
    from flutpu_torch.codec.decode import decode_scan_to_coefs
    from flutpu_torch.codec.fvc import (FvcDecoder, FvcEncoder,
                                        fvc_residuals)
    from flutpu_torch.codec.jpeg import JpegEncoder
    from flutpu_torch.codec.ops.frontend import front_end_444
    from flutpu_torch.codec.ops.testsrc import gradient_ball_frames
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    card = FvcDecoder(dev)
    frames = gradient_ball_frames(PH, PW, 2 * CHUNK, 0, device=dev)[
        :, :H, :W]
    src = frames.cpu().numpy()
    sources = [src[:CHUNK], src[CHUNK:]]
    for hier, kernel in ((False, "motion_search_mc"),
                         (True, "motion_search_mc_hier")):
        enc = FvcEncoder(QUALITY, motion=True, subpel=True, hier=hier,
                         search_range=SEARCH_RANGE, device=dev)
        (chunks, n), busy, launches = _traced(lambda: _count_launches(
            lambda: [enc.encode_chunk(frames[c * CHUNK:(c + 1) * CHUNK])
                     for c in range(2)]))
        label = f"14c FvcEncoder(subpel=True{', hier=True' if hier else ''})"
        _require(n[kernel] > 0 and n["chroma_mc"] == 0
                 and n["pack_segments"] > 0,
                 f"{label}: {kernel} and K2 must launch, K4 not ({n})")
        add(n)
        _require(all(c[5] & 4 for c in chunks), f"{label}: flags bit 2")
        worst, d_rgb, d_psnr = _check_chunks(lib, chunks, sources, label)
        el = _element_frames(f"cudafvcdec device={dev}", chunks)
        _require(np.array_equal(el, np.concatenate(
            [card.decode_chunk(c)[0] for c in chunks])),
            f"{label}: cudafvcdec differs from FvcDecoder")
        print(f"{label}: 2 chunks of {CHUNK} at 1080p, launches {n}; "
              f"through cudafvcdec on the card at >= {worst:.2f} dB; CPU "
              f"decode max |dRGB| {d_rgb}, max dPSNR {d_psnr:.4f} dB; "
              "encode " + _busy_line(2, busy, launches, "chunk"), flush=True)
    # cudahype with half-pel, held per chunk as 13c holds its chunks
    desc = (f"cudahype codec=fvc-motion subpel=true chunks={HYPE_CHUNKS} "
            f"gop-size={CHUNK} search-range={SEARCH_RANGE} device={dev}")
    caps = f"video/x-raw, format=RGB, width={W}, height={H}, framerate=30/1"
    clip = gradient_ball_frames(PH, PW, FVC_HYPE_FRAMES[0], 0, device=dev)[
        :, :H, :W].cpu().numpy()
    (out, wall, _), n = _count_launches(lambda: _harness_run(desc, clip,
                                                             caps))
    _require(n["motion_search_mc"] > 0 and n["chroma_mc"] == 0,
             f"{desc}: K3 must launch, K4 not ({n})")
    add(n)
    n_chunks = FVC_HYPE_FRAMES[0] // CHUNK
    _require(len(out) == n_chunks, f"{desc}: {len(out)} chunks")
    ref = FvcEncoder(QUALITY, motion=True, subpel=True,
                     search_range=SEARCH_RANGE, device=dev)
    srcs = []
    for ci, b in enumerate(out):
        s_ = clip[ci * CHUNK:(ci + 1) * CHUNK]
        srcs.append(s_)
        _require_same(bytes(b.data), ref.encode_chunk(s_),
                      f"{desc} chunk {ci}")
    worst, d_rgb, d_psnr = _check_chunks(lib, [bytes(b.data) for b in out],
                                         srcs, f"14c {desc}")
    print(f"14c {desc}: {len(out)} chunks in order in {wall:.2f} s "
          f"({FVC_HYPE_FRAMES[0] / wall:.1f} frames/s from host memory); "
          f"each byte-identical to a per-chunk encode on the card; >= "
          f"{worst:.2f} dB; CPU decode max |dRGB| {d_rgb}, max dPSNR "
          f"{d_psnr:.4f} dB; launches {n}", flush=True)
    # 4:4:4: 1080 rows are a multiple of 8, so the coded size is the frame's
    gop = frames[:GOP]
    jenc = JpegEncoder(QUALITY, subsample=False, device=dev)
    jenc.encode_gop(gop)    # sizes the entropy stage, as a stream would
    (payloads, n), busy, launches = _traced(lambda: _count_launches(
        lambda: jenc.encode_gop(gop)))
    _require(n["pack_segments"] > 0 and n["front_end"] == 0,
             f"14c 4:4:4 GOP: K2 must launch, K1 not ({n})")
    add(n)
    planes = [gop[..., c].contiguous() for c in range(3)]
    coefs = front_end_444(*planes, jenc._qy_dev, jenc._qc_dev)
    worst = _check_frames(lib, payloads, coefs, gop, jenc, "14c 4:4:4 GOP",
                          size=(H, W, H, W), subsample=False)
    from flutpu_torch.core import make
    dec = make("cudajpegdec", device=str(dev))
    worst_dec = min(_psnr(dec.decode(p_), s_) for p_, s_ in zip(
        payloads, gop.cpu().numpy()))
    _require(worst_dec >= MIN_PSNR, f"14c 4:4:4 GOP through cudajpegdec: "
             f"{worst_dec:.2f} dB")
    fenc = FvcEncoder(QUALITY, subsample=False, device=dev)
    chunk, n = _count_launches(lambda: fenc.encode_chunk(frames[:CHUNK]))
    _require(n["pack_segments"] > 0 and n["front_end"] == 0,
             f"14c 4:4:4 FVC chunk: K2 must launch, K1 not ({n})")
    add(n)
    hdr, recs = FvcDecoder.parse_chunk(chunk)
    _require(not hdr["subsample"] and hdr["version"] == 1,
             "14c 4:4:4 FVC chunk header")
    res = [r.cpu().numpy() for r in fvc_residuals(*front_end_444(
        *(frames[:CHUNK, ..., c].contiguous() for c in range(3)),
        fenc._scan_coder._qy_dev, fenc._scan_coder._qc_dev))]
    for i, (_, _, payload) in enumerate(recs):
        got = decode_scan_to_coefs(payload, W // 8, H // 8, W // 8, H // 8,
                                   False)
        _require(got is not None and all(np.array_equal(a, r[i])
                                         for a, r in zip(got, res)),
                 f"14c 4:4:4 FVC frame {i}: scan != front end residuals")
        _require(_native_scan(lib, *got, subsample=False) == payload,
                 f"14c 4:4:4 FVC frame {i}: scan != flu_jpeg_encode_scan")
    el = _element_frames(f"cudafvcdec device={dev}", [chunk])
    worst_fvc = min(_psnr(a, b) for a, b in zip(el, src[:CHUNK]))
    _require(worst_fvc >= MIN_PSNR, f"14c 4:4:4 FVC: {worst_fvc:.2f} dB")
    print(f"14c 4:4:4: one {gop.shape[0]}-frame JpegEncoder(subsample=False) "
          f"GOP and one FvcEncoder(subsample=False) chunk at 1080p (K2 "
          f"launched, K1 not); every scan decodes to the plain 4:4:4 front "
          f"end's coefficients (the chunk's to their residuals) and equals "
          f"flu_jpeg_encode_scan; >= {worst:.2f} dB, through cudajpegdec "
          f">= {worst_dec:.2f} dB, through cudafvcdec >= {worst_fvc:.2f} dB; "
          "the GOP's encode (after one warm GOP) " + _busy_line(
              1, busy, launches, "GOP"), flush=True)
    return total


def _with_coded_size(chunk: bytes, h: int) -> bytes:
    """The chunk's header rewritten to frame height ``h`` with the
    coded-size extension (header flags bit 4: the chunk's coded width and
    height) after the v2 search-range byte."""
    import struct
    ver, flags, w, ph = struct.unpack(">BBHH", chunk[4:10])
    off = 13 if ver >= 2 else 12
    return (chunk[:4] + struct.pack(">BBHH", ver, flags | 16, w, h)
            + chunk[10:off] + struct.pack(">HH", w, ph) + chunk[off:])


def _run_coded_size(dev):
    """Phase 14d: a P chunk coded at 1088 rows, its header rewritten to
    1080 rows plus the coded-size extension (1920, 1088), decodes on the
    card (FvcDecoder and cudafvcdec) to the 1080-row crop of the
    1088-row chunk's decode. Returns the launch counts of its encode."""
    import numpy as np
    from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
    from flutpu_torch.codec.ops.testsrc import gradient_ball_frames
    enc = FvcEncoder(QUALITY, motion=True, search_range=SEARCH_RANGE,
                     device=dev)
    tall = gradient_ball_frames(PH, PW, CHUNK, 0, device=dev)
    chunk, n = _count_launches(lambda: enc.encode_chunk(tall))
    ext = _with_coded_size(chunk, H)
    card = FvcDecoder(dev)
    hdr = card.parse_chunk(ext)[0]
    _require((hdr["height"], hdr["coded_height"], hdr["coded_width"])
             == (H, PH, PW), f"14d header {hdr}")
    full = card.decode_chunk(chunk)[0]
    got = card.decode_chunk(ext)[0]
    el = _element_frames(f"cudafvcdec device={dev}", [ext])
    _require(got.shape == (CHUNK, H, W, 3) and np.array_equal(
        got, full[:, :H]) and np.array_equal(el, got),
        "14d: the coded-size chunk does not decode to the taller crop")
    print(f"14d coded-size extension: a {PH}-row P chunk rewritten to {H} "
          f"rows + (pw, ph) = ({PW}, {PH}) decodes on the card (FvcDecoder "
          f"and cudafvcdec) to the {H}-row crop of its {PH}-row decode",
          flush=True)
    return n


# -- 15. the FVC encoder's remaining options: search ranges 33-126, rate
# control, the ABR ladder, batched chunks from the on-device source, io ----

WIDE_RANGES = (33, 48, 64, 126)   # K3 against its plain version
WIDE_HIER_RANGES = (40, 64, 126)  # K5 likewise
WIDE_R = 64                # the encoder's range in 15b; K6a's and C = 8's
PAN_FRAMES, PAN_STEP = 16, (8, 48)   # 15b: rows, columns per frame
RC_FRAMES, RC_BITRATE = 64, 6_000_000
RC_MIN_Q, RC_MAX_Q = 10, 97        # the qualities the controller may pick
LADDER_FRAMES = 48
LADDER_RUNGS = "1920x1080@85,1280x720@80,640x360@75"
BATCH = 4


def run_wide(dev, lib, lap):
    """Phase 15. Returns (the kernels' launch counts over its paths, the
    wide-range kernels' results)."""
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    traces = _fresh_traces()
    results = _wide_kernels(dev, traces["hier"])
    lap("15a wide-range kernels")
    add(_wide_encoder(dev, lib))
    lap("15b wide search in the encoder")
    add(_rate_control(dev))
    lap("15c rate control")
    add(_ladder(dev))
    lap("15d ABR ladder")
    add(_batched_src(dev, traces["batch"]))
    lap("15e batched source")
    _io(dev)
    lap("15f io")
    return total, results


#: the argument that runs only ``_trace_checks`` (in a child process)
TRACE_CHECKS = "--trace-checks"


def _trace_checks(dev):
    """The device launches of one call each, traced in a process of their
    own: K5 at every range of WIDE_HIER_RANGES on a 1080p pair, and one
    batched-source dispatch and finalize of BATCH chunks (after a warm
    one). Late in a long run torch.profiler was seen to lose whole windows
    of device activity, in a fresh process none."""
    import numpy as np
    import torch
    from flutpu_torch.codec.fvc import FvcEncoder
    from flutpu_torch.codec.ops import motion_kernels as M
    rng = np.random.default_rng(3)
    prev = torch.from_numpy(rng.uniform(0, 255, (PH, PW)).astype(np.float32)
                            ).to(dev)
    cur = torch.roll(prev, (5, -40), (0, 1))
    hier = {str(r): _call_launches(
        lambda: M.motion_search_mc_hier(cur, prev, r), dev)
        for r in WIDE_HIER_RANGES}
    enc = FvcEncoder(QUALITY, motion=True, device=dev)
    batch = _batch_fn(enc, dev)
    batch()
    return {"hier": hier, "batch": _call_launches(batch, dev)}


def _fresh_traces():
    """``_trace_checks`` in a child process on the same card → its
    result."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          TRACE_CHECKS], capture_output=True, text=True,
                         timeout=600)
    _require(res.returncode == 0, f"the trace process failed: "
             f"{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _batch_fn(enc, dev):
    """15e's call: BATCH chunks of CHUNK gradient-ball frames from the
    on-device source through one dispatch and finalize."""
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes

    def src(ph, pw, n, start):
        return gradient_ball_planes(ph, pw, n, start, device=dev)

    def batch():
        return enc.encode_chunk_batch_finalize(
            enc.encode_chunk_batch_dispatch_src(src, 0, CHUNK, H, W,
                                                batch=BATCH))
    return batch


def _once_ms(fn):
    """(fn's result, device ms of that one call: CUDA events, synchronised;
    a plain version's launches pace with the host)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _issue_floor_ms(diffs: float, sms: int, mhz: float) -> float:
    """The least time for ``diffs`` absolute differences at the fp32
    issue rate: each is two instructions (a subtract, an add taking |.|
    of its operands), and an SM issues 128 lanes' fp32 instructions per
    clock."""
    return diffs * 2 / (sms * 128 * mhz * 1e6) * 1e3


class _ClockSampler:
    """``nvidia-smi``'s SM clock sampled every 100 ms while a ``with``
    block runs (read once at its end where the block ended before the
    first sample); ``max_mhz``: the card's maximum SM clock."""

    QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"]

    def __init__(self):
        out = subprocess.run(self.QUERY, capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
        self.max_mhz = int(out.split(",")[1])
        self.seen = []

    def __enter__(self):
        self.proc = subprocess.Popen(self.QUERY + ["-lms", "100"],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = out.splitlines()
        if not rows:   # a window shorter than the sampler's start: one read
            rows = subprocess.run(self.QUERY, capture_output=True, text=True,
                                  timeout=60).stdout.splitlines()
        for row in rows:
            vals = [v.strip() for v in row.split(",")]
            if len(vals) == 2 and vals[0].isdigit():
                self.seen.append(int(vals[0]))
        return False

    def __str__(self):
        if not self.seen:
            return f"not sampled (max {self.max_mhz} MHz)"
        return (f"{min(self.seen)}-{max(self.seen)} MHz in {len(self.seen)} "
                f"samples (max {self.max_mhz} MHz)")


def _wide_kernels(dev, hier_traces):
    """Phase 15a: K3 at r = 33, 48, 64 and 126, K6a (8x8) at 64 on the
    pooled planes, K5 at 40, 64 and 126 (one launch per call) against
    their plain versions on two of phase 5's 1080p pairs (K5 also on a
    flat pair and a pair with NaN); K4 on vectors up to ±126; K3 with a
    chunk axis at C = 8 and r = 64. Each timed beside its bound and its
    issue floor (``_issue_floor_ms`` at the card's maximum SM clock, the
    clock sampled during the timing), with the kernel's share of each.
    Returns the wide-range kernels' results (at r = 64)."""
    import numpy as np
    import torch
    from flutpu_torch.codec.ops import motion_kernels as M
    from flutpu_torch.codec.ops.colorspace import planes_to_i420, \
        subsample_420
    from flutpu_torch.codec.ops.motion import compensate_blocks
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes

    pairs = _motion_pairs(dev, np.random.default_rng(1))
    two = [pairs[1], pairs[2]]   # rolled plane + noise; in-loop reference
    rows = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clocks = _ClockSampler()

    def line(name, r, k_ms, p_ms, bound, shape, diffs):
        rows[(name, r)] = (k_ms, p_ms, bound)
        floor = _issue_floor_ms(diffs, sms, clocks.max_mhz)
        print(f"{name} r={r}: kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms "
              f"per {shape}; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}; {k_ms / bound['bound_ms']:.2f}x, "
              f"share {bound['bound_ms'] / k_ms:.2f}); issue floor "
              f"{floor:.4f} ms ({diffs:.4g} differences x 2 fp32 "
              f"instructions at {sms} SMs x 128 lanes x {clocks.max_mhz} "
              f"MHz; share {floor / k_ms:.2f})", flush=True)

    for r in WIDE_RANGES:
        for label, cur, prev in two:
            plain, p_ms = _once_ms(
                lambda: M.motion_search_mc_plain(cur, prev, r))
            _hold_search(f"{label}, r={r}", "motion_search_mc",
                         M.motion_search_mc(cur, prev, r), plain, cur, prev,
                         r, 16, True,
                         lambda p, m: M.motion_compensate(p, m, r))
        with clocks:
            k_ms = _time_ms(lambda: M.motion_search_mc(cur, prev, r), 10)
        line("motion_search_mc", r, k_ms, p_ms,
             _search_bound(PH, PW, 16, r), "1088x1920 luma frame",
             PH * PW * (2 * r + 1) ** 2)

    for label, cur, prev in two:
        pc, pp = subsample_420(cur), subsample_420(prev)
        plain, p_ms = _once_ms(
            lambda: M.motion_search_mc_blocks_plain(pc, pp, WIDE_R, 8))
        _hold_search(f"{label}, pooled 544x960, 8x8, r={WIDE_R}",
                     "motion_search_mc_blocks",
                     M.motion_search_mc_blocks(pc, pp, WIDE_R, 8), plain,
                     pc, pp, WIDE_R, 8, True,
                     lambda p, m: compensate_blocks(p, m, 8))
    with clocks:
        k_ms = _time_ms(lambda: M.motion_search_mc_blocks(pc, pp, WIDE_R, 8),
                        10)
    line("motion_search_mc_blocks (8x8)", WIDE_R, k_ms, p_ms,
         _search_bound(PH // 2, PW // 2, 8, WIDE_R), "pooled 544x960 plane",
         (PH // 2) * (PW // 2) * (2 * WIDE_R + 1) ** 2)

    for r in WIDE_HIER_RANGES:
        for label, cur, prev in _hier_pairs(two, dev):
            plain, p_ms = _once_ms(
                lambda: M.motion_search_mc_hier_plain(cur, prev, r))
            _hold_search(f"{label}, r={r}", "motion_search_mc_hier",
                         M.motion_search_mc_hier(cur, prev, r), plain, cur,
                         prev, r, 16, False,
                         lambda p, m: M.motion_compensate(p, m, r))
        cur, prev = two[1][1:]
        _, p_ms = _once_ms(lambda: M.motion_search_mc_hier_plain(cur, prev,
                                                                 r))
        with clocks:
            k_ms = _time_ms(lambda: M.motion_search_mc_hier(cur, prev, r),
                            10)
        rc = max(1, r // 2)
        line("motion_search_mc_hier", r, k_ms, p_ms, _search_bound(
            PH, PW, 16, 1, (PH // 2) * (PW // 2) * (2 * rc + 1) ** 2 * 3
            + 2 * PH * PW), "1088x1920 luma frame",
            (PH // 2) * (PW // 2) * (2 * rc + 1) ** 2 + 9 * PH * PW)
        names = hier_traces[str(r)]
        _require(len(names) == 1 and "motion_search_hier_wide" in names[0],
                 f"a call of K5 at r={r} is not one launch: {names}")
    print(f"motion_search_mc_hier above r=32, one call (torch.profiler, in "
          f"a process of its own): {names}", flush=True)
    print(f"SM clock during the wide kernels' timing: {clocks}", flush=True)

    rng = np.random.default_rng(126)
    cb, cr = (torch.from_numpy(rng.normal(128, 30, (PH // 2, PW // 2))
                               .astype(np.float32)).to(dev)
              for _ in range(2))
    mv = torch.from_numpy(rng.integers(-126, 127, (PH // 16, PW // 16, 2))
                          .astype(np.int32)).to(dev)
    _require(all(torch.equal(a, b) for a, b in zip(
        M.chroma_mc(cb, cr, mv, 126), M.chroma_mc_plain(cb, cr, mv, 126))),
        "chroma_mc differs from its plain version on vectors to ±126")
    print(f"chroma_mc vs plain (random vectors to ±126, "
          f"{int(((mv < 0) & (mv % 2 == 1)).sum())} odd negative "
          "components): bit-identical", flush=True)

    c = HYPE_CHUNKS
    y = planes_to_i420(*gradient_ball_planes(PH, PW, 2 * c, 0,
                                             device=dev))[0]
    cur, prev = y[1::2].contiguous(), y[0::2].contiguous()
    mv, pred = M.motion_search_mc(cur, prev, WIDE_R)
    for k in range(c):
        one = M.motion_search_mc(cur[k], prev[k], WIDE_R)
        _require(torch.equal(mv[k], one[0]) and torch.equal(pred[k], one[1]),
                 f"motion_search_mc r={WIDE_R}: chunk {k} of a batched "
                 "launch differs from its own launch")
    _time_batched(f"motion_search_mc r={WIDE_R}",
                  lambda: M.motion_search_mc(cur, prev, WIDE_R),
                  [lambda k=k: M.motion_search_mc(cur[k], prev[k], WIDE_R)
                   for k in range(c)], c,
                  rows[("motion_search_mc", WIDE_R)][0])
    torch.cuda.synchronize()

    def record(name):
        k_ms, p_ms, bound = rows[(name, WIDE_R)]
        return dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, **bound)

    return {"motion_search_mc_wide": record("motion_search_mc"),
            "motion_search_mc_hier_wide": record("motion_search_mc_hier"),
            "motion_search_mc_blocks_wide":
                record("motion_search_mc_blocks (8x8)")}


def _pan_frames():
    """15b's content: a seeded 1080p texture (uniform noise smoothed by six
    passes of a 3x3 box, wrapping: benches/rd_sweep.py's ``pan`` smooths
    once, which leaves detail no q85 chunk codes at 30 dB) panned
    PAN_STEP pixels per frame, wrapping."""
    import numpy as np
    rng = np.random.default_rng(15)
    tex = rng.integers(0, 256, (H, W, 3)).astype(np.float32)
    for _ in range(6):
        pad = np.pad(tex, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        tex = sum(pad[i:i + H, j:j + W] for i in range(3)
                  for j in range(3)) / 9.0
    tex = tex.astype(np.uint8)
    return np.stack([np.roll(tex, (PAN_STEP[0] * i, PAN_STEP[1] * i),
                             axis=(0, 1)) for i in range(PAN_FRAMES)])


def _decode_checks(dev, chunks, sources, label, min_q=None):
    """Every chunk through ``cudafvcdec`` on the card (>= 30 dB against
    its (F, H', W', 3) numpy source, but where the chunk's quality is
    ``min_q``) and through ``FvcDecoder`` on the CPU (the card's frames
    bit for bit) → (lowest PSNR per chunk, largest card/CPU difference,
    dB)."""
    import numpy as np
    from flutpu_torch.codec.fvc import FvcDecoder
    card = _element_frames(f"cudafvcdec device={dev}", chunks)
    cpu = FvcDecoder("cpu")
    worst, d_psnr, f0 = [], 0.0, 0
    for data in chunks:
        n = data[11]
        src = sources[f0:f0 + n]
        a, b = card[f0:f0 + n], cpu.decode_chunk(data)[0]
        _require(np.array_equal(a, b), f"{label}: the card's decode differs "
                 "from the CPU's")
        p = [_psnr(x, s) for x, s in zip(a, src)]
        d_psnr = max([d_psnr] + [abs(q - _psnr(y, s))
                                 for q, y, s in zip(p, b, src)])
        worst.append(min(p))
        _require(min(p) >= MIN_PSNR or data[10] == min_q,
                 f"{label}: a chunk at {min(p):.2f} dB (quality {data[10]})")
        f0 += n
    _require(f0 == len(sources), f"{label}: {f0} frames decoded")
    return worst, d_psnr


def _wide_encoder(dev, lib):
    """Phase 15b: ``cudafvcenc motion=true search-range=64 gop-size=8`` on
    16 frames of a 1080p pan of 48 columns and 8 rows per frame, full and
    ``search=hier``: K3 (K5) launched above r = 32, every chunk decoded on
    the card and the CPU, vectors past ±32, and a smaller stream than at
    ±32. Returns the launch counts (of the ±64 encodes)."""
    import numpy as np
    from flutpu_torch.codec.fvc import FvcDecoder
    frames = _pan_frames()
    caps = f"video/x-raw, format=RGB, width={W}, height={H}, framerate=30/1"
    total = {}
    for search, wrapper in (("full", "motion_search_mc"),
                            ("hier", "motion_search_mc_hier")):
        sizes = {}
        for r in (WIDE_R, 32):
            desc = (f"cudafvcenc motion=true search-range={r} gop-size="
                    f"{CHUNK} search={search} device={dev}")
            (bufs, wall, _), counts = _count_launches(
                lambda: _harness_run(desc, frames, caps))
            chunks = [bytes(b.data) for b in bufs]
            sizes[r] = sum(map(len, chunks))
            if r != WIDE_R:
                continue
            for k in (wrapper, "chroma_mc", "pack_segments"):
                _require(counts[k] > 0, f"15b {search}: {k} not launched")
            _require(counts[wrapper + "_wide"] == counts[wrapper],
                     f"15b {search}: {wrapper} ran below r=33")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            worst, d_psnr = _decode_checks(dev, chunks, frames,
                                           f"15b {search}")
            vecs = np.concatenate([np.abs(v).reshape(-1, 2) for c in chunks
                                   for _, v, _ in FvcDecoder.parse_chunk(c)[1]
                                   if v is not None])
            share = float((vecs.max(axis=1) > 32).mean())
            _require(share > 0, f"15b {search}: no vector beyond ±32")
            print(f"15b {search} search, r={WIDE_R}: {len(chunks)} chunks of "
                  f"a {PAN_STEP[1]}-column pan in {wall:.3f} s, "
                  f"{counts[wrapper + '_wide']} launches of {wrapper} above "
                  f"r=32; {share:.3f} of the P vectors beyond ±32; PSNR "
                  f"through cudafvcdec >= {min(worst):.2f} dB, CPU decode "
                  f"within {d_psnr:.4f} dB", flush=True)
        _require(sizes[WIDE_R] < sizes[32], f"15b {search}: ±{WIDE_R} is not "
                 f"smaller than ±32 ({sizes})")
        print(f"15b {search} search: stream {sizes[WIDE_R]} bytes at "
              f"±{WIDE_R}, {sizes[32]} at ±32", flush=True)
    return total


def _controller(chunks, frames, dev, target):
    """flutpu's fvcenc controller replayed on the host over the chunk
    sizes: each chunk's quality must be round(q_est), or, where the first
    encode at that quality (made again here on the card) came out over
    1.3 times the budget, the retry's max(10, q - round(12 log2(size /
    budget))); then q_est = clip(q - 12 log2(size / budget), 10, 97).
    Returns the qualities."""
    import numpy as np
    from flutpu_torch.codec.fvc import FvcEncoder
    est, qs = float(QUALITY), []
    for ci, data in enumerate(chunks):
        q, got = int(round(est)), data[10]
        if got != q:
            first = len(FvcEncoder(q, motion=True, device=dev).encode_chunk(
                frames[ci * CHUNK:(ci + 1) * CHUNK]))
            q2 = max(RC_MIN_Q, q - int(round(12 * np.log2(first / target))))
            _require(first > target * 1.3 and q2 < q and got == q2,
                     f"15c chunk {ci}: quality {got}, the controller gives "
                     f"{q} (first encode {first} bytes, retry {q2})")
        else:
            n = len(data)
            _require(n <= target * 1.3 or max(RC_MIN_Q, q - int(round(
                12 * np.log2(n / target)))) >= q,
                f"15c chunk {ci}: {n} bytes at quality {q} owed a retry")
        est = float(np.clip(got - 12 * np.log2(max(len(data) / target,
                                                   1e-6)),
                            RC_MIN_Q, RC_MAX_Q))
        qs.append(got)
    return qs


def _rate_control(dev):
    """Phase 15c: ``cudafvcenc motion=true bitrate=6000000 gop-size=8`` on
    64 frames of 1080p gradient-ball at 30 frames/s: each chunk's
    quality is the controller's for the sizes before it, each chunk
    decodes (card and CPU). Returns the launch counts."""
    import numpy as np
    from flutpu_torch.codec.ops.testsrc import gradient_ball_frames
    frames = np.concatenate([
        gradient_ball_frames(H, W, CHUNK, i, device=dev).cpu().numpy()
        for i in range(0, RC_FRAMES, CHUNK)])
    desc = (f"cudafvcenc motion=true bitrate={RC_BITRATE} gop-size={CHUNK} "
            f"device={dev}")
    caps = f"video/x-raw, format=RGB, width={W}, height={H}, framerate=30/1"
    (bufs, wall, _), counts = _count_launches(
        lambda: _harness_run(desc, frames, caps))
    chunks = [bytes(b.data) for b in bufs]
    _require(len(chunks) == RC_FRAMES // CHUNK, f"15c: {len(chunks)} chunks")
    for k in ("motion_search_mc", "chroma_mc", "pack_segments"):
        _require(counts[k] > 0, f"15c: {k} not launched")
    # the element's budget: the chunk's duration at the bitrate
    target = max(1, int(RC_BITRATE / 8 * (CHUNK * FRAME_NS) / 1e9))
    qs = _controller(chunks, frames, dev, target)
    worst, d_psnr = _decode_checks(dev, chunks, frames, "15c", RC_MIN_Q)
    sizes = [len(c) for c in chunks]
    tail = sum(sizes[-5:]) * 8 / (5 * CHUNK * FRAME_NS / 1e9)
    print(f"15c rate control: {len(chunks)} chunks in {wall:.3f} s, budget "
          f"{target} bytes per chunk; sizes {sizes}; qualities {qs} (the "
          f"controller's, replayed on the host); last 5 chunks "
          f"{tail / 1e6:.3f} Mbit/s against {RC_BITRATE / 1e6:.3f}; PSNR per "
          f"chunk >= {[round(p, 2) for p in worst]} dB, CPU decode within "
          f"{d_psnr:.4f} dB", flush=True)
    return counts


class _MeterSchedule:
    """The port's BwMeter, fed one window of ``rates`` bytes in turn each
    time the ladder asks for its estimate (a window closes after 0.6 s of
    its clock: a forced window)."""

    def __init__(self, rates):
        from flutpu_torch.fluc.bwmeter import BwMeter
        self.meter = BwMeter()
        self.meter.session_start()
        self.meter.data(0, _now=0.0)
        self.now, self.rates, self.seen = 0.0, list(rates), []

    def stats(self):
        self.now += 0.6
        self.meter.data(self.rates.pop(0), _now=self.now)
        self.seen.append(self.meter.stats()[1])
        return self.meter.stats()


def _ladder(dev):
    """Phase 15d, the slice's main path: 48 frames of 1080p ``videotestsrc
    pattern=ball ! cudafvcladderenc`` (three rungs, motion, B frames,
    adaptive) into four appsinks; each rung's chunk equal to a card
    FvcEncoder's on the same scaled frames, the card's scaled frames within
    one level of the CPU's, every rung decoded at >= 30 dB, and the active
    rung following the meter down to the lowest rung and back. Returns the
    launch counts."""
    import numpy as np
    import torch
    from flutpu_torch.codec import ladder as L
    from flutpu_torch.codec.fvc import FvcEncoder
    from flutpu_torch.core import parse_launch
    from flutpu_torch.core.elements import make_test_frame
    rungs = L.parse_rungs(LADDER_RUNGS)
    n_chunks = LADDER_FRAMES // CHUNK
    fast, slow = 10 ** 9, 100      # bytes per 0.6 s window
    meter = _MeterSchedule([fast, fast, slow, fast, fast, fast])
    p = parse_launch(
        f"videotestsrc num-buffers={LADDER_FRAMES} pattern=ball width={W} "
        f"height={H} ! cudafvcladderenc name=lad rungs='{LADDER_RUNGS}' "
        f"motion=true bframes=1 gop-size={CHUNK} adaptive=true device={dev} "
        + " ".join(f"lad.src_{i} ! appsink name=s{i}"
                   for i in range(len(rungs)))
        + " lad.src_active ! appsink name=act")
    p.get_by_name("lad")._meter = meter

    def run():
        t0 = time.perf_counter()
        p.play()
        out = {}
        try:
            for i in range(len(rungs)):
                s = p.get_by_name(f"s{i}")
                out[i] = []
                while (b := s.try_pull_buffer(timeout=120)) is not None:
                    out[i].append(bytes(b.data))
            # src_active carries no EOS: one buffer per chunk
            act = [p.get_by_name("act").try_pull_buffer(timeout=120)
                   for _ in range(n_chunks)]
        finally:
            p.stop()
        return out, act, time.perf_counter() - t0

    (out, act, wall), counts = _count_launches(run)
    for k in ("motion_search_mc", "chroma_mc", "pack_segments"):
        _require(counts[k] > 0, f"15d: {k} not launched")
    _require(all(len(c) == n_chunks for c in out.values()),
             f"15d: chunks per rung {[len(c) for c in out.values()]}")
    picked = [b.meta["rung"] for b in act]
    _require(picked == [0, 0, 2, 0, 0, 0],
             f"15d: src_active rungs {picked} for a fast, slow, fast meter")
    _require(all(bytes(b.data) == out[r][ci]
                 for ci, (b, r) in enumerate(zip(act, picked))),
             "15d: src_active differs from its rung's chunk")
    frames = np.stack([make_test_frame("ball", W, H, i)
                       for i in range(LADDER_FRAMES)])
    worst = {}
    for i, rung in enumerate(rungs):
        enc = FvcEncoder(rung.quality, motion=True, bframes=1, device=dev)
        scaled = []
        for ci in range(n_chunks):
            dev_frames = torch.from_numpy(
                frames[ci * CHUNK:(ci + 1) * CHUNK]).to(dev)
            s_ = L.scale_rung(dev_frames, rung)
            _require(enc.encode_chunk(s_) == out[i][ci],
                     f"15d rung {i} chunk {ci}: differs from a card "
                     "FvcEncoder's on the same scaled frames")
            scaled.append(s_.cpu().numpy())
            if ci == 0:
                cpu = L.scale_rung(dev_frames.cpu(), rung).numpy()
                d = int(np.abs(scaled[0].astype(int) - cpu).max())
                _require(d <= 1, f"15d rung {i}: card and CPU scaling "
                         f"differ by {d} levels")
        w_, _ = _decode_checks(dev, out[i], np.concatenate(scaled),
                               f"15d rung {i}")
        worst[f"{rung.width}x{rung.height}"] = round(min(w_), 2)
    # device busy and launches: two chunks through the element's encoders
    el = p.get_by_name("lad")
    _, busy, launches = _traced(lambda: [L.encode_ladder_chunk(
        frames[ci * CHUNK:(ci + 1) * CHUNK], rungs, motion=True,
        encoders=el._encoders, bframes=1, device=dev) for ci in range(2)])
    print(f"15d ladder (rungs {LADDER_RUNGS}, motion, bframes=1, adaptive): "
          f"{LADDER_FRAMES} frames in {wall:.3f} s = "
          f"{LADDER_FRAMES / wall:.2f} frames/s through videotestsrc; each "
          f"rung's chunks = a card FvcEncoder's on the same scaled frames; "
          f"PSNR per rung >= {worst} dB; src_active rungs {picked} for "
          f"estimates {[round(x / 1e6, 3) for x in meter.seen]} Mbit/s; "
          "kernel launches per chunk per rung "
          + str({k: round(v / n_chunks / len(rungs), 2)
                 for k, v in counts.items() if v}) + "; "
          + _busy_line(2 * len(rungs), busy, launches, "chunk and rung"),
          flush=True)
    return counts


def _batched_src(dev, names):
    """Phase 15e: ``encode_chunk_batch_dispatch_src`` of 4 chunks of 8
    gradient-ball frames at 1080p: one device-to-host copy (``names``: the
    device launches of one such call, traced in a process of its own),
    each chunk byte-identical to its own ``encode_chunk_dispatch_src``.
    Returns the launch counts."""
    from flutpu_torch.codec.fvc import FvcEncoder
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    enc = FvcEncoder(QUALITY, motion=True, device=dev)

    def src(ph, pw, n, start):
        return gradient_ball_planes(ph, pw, n, start, device=dev)

    batch = _batch_fn(enc, dev)
    batch()   # a fresh encoder learns its sizes on its first dispatch
    chunks, counts = _count_launches(batch)
    for k in ("motion_search_mc", "chroma_mc", "pack_segments"):
        _require(counts[k] > 0, f"15e: {k} not launched")
    copies = sum("DtoH" in n for n in names)
    _require(copies == 1, f"15e: {copies} device-to-host copies")
    for b, chunk in enumerate(chunks):
        one = enc.encode_chunk_finalize(enc.encode_chunk_dispatch_src(
            src, b * CHUNK, CHUNK, H, W))
        _require_same(chunk, one, f"15e chunk {b}")
    print(f"15e batched source: {BATCH} chunks of {CHUNK} frames in one "
          f"dispatch, {copies} device-to-host copy, {len(names) / BATCH:g} "
          f"device launches per chunk (torch.profiler, in a process of its "
          f"own); kernel launches "
          f"{ {k: v for k, v in counts.items() if v} }; {BATCH} of {BATCH} "
          f"byte-identical to single dispatches", flush=True)
    return counts


def _png(pixels) -> bytes:
    """A PNG of an (h, w, 3 or 4) uint8 array, by the writer of
    examples/torch/subtitle_burnin.py."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch", "subtitle_burnin.py")
    spec = importlib.util.spec_from_file_location("subtitle_burnin", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.png_bytes(pixels)


def _image_doc(ref, png) -> bytes:
    import base64
    return f"""<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling"
    xmlns:smpte="http://www.smpte-ra.org/schemas/2052-1/2010/smpte-tt">
  <head>
    <metadata>
      <smpte:image xml:id="img1" imagetype="PNG" encoding="Base64">{
          base64.b64encode(png).decode()}</smpte:image>
    </metadata>
    <layout>
      <region xml:id="r1" tts:origin="5% 5%" tts:extent="60% 60%"
              smpte:backgroundImage="{ref}"/>
    </layout>
  </head>
  <body><div>
    <p begin="0s" end="1s" region="r1" tts:color="white">on image</p>
  </div></body>
</tt>""".encode()


class Loopback:
    """An HTTP server on 127.0.0.1 for the duration of a ``with`` block,
    serving ``files`` ({path: bytes}); anything else is 404. ``url(path)``
    names a file. (The tests use it too.)"""

    def __init__(self, files):
        import http.server
        import threading

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = files.get(self.path)
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                    Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self._srv.server_address[1]}{path}"

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=10)


def _io(dev):
    """Phase 15f: the port's downloader fetches a file:// file and a
    loopback HTTP URL served here, the process-global bandwidth meter
    counts their bytes, and a TTML document whose background image is that
    loopback URL renders through ``cudattmlrender`` on the card
    pixel-identical to the document with the image embedded as ``#id``."""
    import tempfile
    import numpy as np
    from flutpu_torch.core import Buffer, Harness
    from flutpu_torch.fluc import bwmeter
    from flutpu_torch.io import DownloadHelper, TaskOutcome
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, 300 * 1024, np.uint8).tobytes()
    img = np.zeros((16, 24, 4), np.uint8)
    img[..., 1], img[..., 3] = 200, 255
    png = _png(img)
    files = {"/payload.bin": payload, "/img.png": png}
    with Loopback(files) as srv:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "payload.bin")
            with open(path, "wb") as fh:
                fh.write(payload)
            total0 = bwmeter.stats()[2]
            with DownloadHelper() as h:
                got_file = h.download(f"file://{path}")
                got_http = h.download(srv.url("/payload.bin"))
            counted = bwmeter.stats()[2] - total0
        for label, (data, outcome, _) in (("file://", got_file),
                                          ("http", got_http)):
            _require(outcome == TaskOutcome.OK and data == payload,
                     f"15f: the {label} download differs ({outcome})")
        _require(counted >= 2 * len(payload), f"15f: the meter counted "
                 f"{counted} bytes of {2 * len(payload)}")

        def render(doc):
            h = Harness(f"cudattmlrender window-width=640 "
                        f"window-height=368 device={dev}")
            h.set_src_caps("application/ttml+xml")
            h.push(Buffer(doc, pts=0))
            h.push_eos()
            out = []
            while (b := h.pull(timeout=60)) is not None:
                out.append(np.asarray(b.data))
            h.teardown()
            return out

        url_w = render(_image_doc(srv.url("/img.png"), png))
        id_w = render(_image_doc("#img1", png))
    _require(len(url_w) == len(id_w) > 0 and all(
        np.array_equal(a, b) for a, b in zip(url_w, id_w)),
        "15f: the URL image's window differs from the #id image's")
    green = int(((url_w[0][..., 1] == 200) & (url_w[0][..., 3] > 0)).sum())
    _require(green > 0, "15f: the background image is not in the window")
    print(f"15f io: file:// and loopback HTTP downloads of {len(payload)} "
          f"bytes equal the file, the meter counted {counted} bytes; a "
          f"loopback-URL background image renders through cudattmlrender on "
          f"the card pixel-identical to the #id image ({green} image "
          "pixels)", flush=True)


# -- 16. several shards and row stripes: BASELINE config 4 --------------------

#: the argument that runs phase 16 alone (in a child process); the path
#: after it receives the phase's launch counts as JSON
PHASE16 = "--phase16"
K4_H, K4_W = 2160, 3840        # BASELINE config 4: hype 4K30
CONFIG4_GOP = 30
CONFIG4_CHUNKS = (8, 4)        # C tried first, and C where 8 does not fit
CONFIG4_PEAK_GIB = 70          # of the card's 80
STRIPES = 2
PAN4K_FRAMES = 16
PAN4K_STEP = (4, 6)            # rows, columns per frame
STRIPE_CHUNKS = 2


def run_striped(dev, lib, lap):
    """Phase 16 in a process of its own (a fresh allocator for 16a's peak,
    fresh profiler windows for its traces). Returns its launch counts."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "phase16.json")
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              PHASE16, out], timeout=600)
        _require(res.returncode == 0, f"phase 16 failed (exit "
                 f"{res.returncode}; its output is above)")
        with open(out) as f:
            counts = json.load(f)
    lap("16 several shards and stripes (child process)")
    return counts


def _phase16(dev):
    """16a-16e on ``dev`` → the launch counts of their paths."""
    from flutpu_torch import _build, native
    lib = native.get_lib()
    _require(lib is not None, "the native library did not build")
    _build.load()
    lap = _Laps()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    add(_config4_jpeg(dev, lib))
    lap("16a config 4 JPEG")
    add(_config4_fvc(dev, lib))
    lap("16b config 4 FVC")
    add(_shards_on_cards(dev))
    lap("16c several shards")
    _two_processes(dev)
    lap("16d two processes")
    _compositor_vmap(dev)
    lap("16e compositor, batched intervals")
    print(f"phase 16 wall times (s): {json.dumps(lap.secs)}", flush=True)
    return total


def _config4_jpeg(dev, lib):
    """16a: 4K gradient-ball frames from host memory through ``cudahype
    codec=jpeg spatial=2 gop-size=30 chunks=C``: C = 8 where its peak
    device memory stays under CONFIG4_PEAK_GIB, else 4. The first
    (probe) run and one ``spatial=1`` run are traced (busy and launches
    per chunk); then ``spatial=1`` and ``spatial=2`` run in turns (1, 2,
    2, 1) for frames/s. Every JFIF byte-identical across the runs and
    under phase 4's checks."""
    import numpy as np
    import torch
    from flutpu_torch.codec.jpeg import JpegEncoder, _edge_pad
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.codec.ops.testsrc import gradient_ball_frames
    caps = (f"video/x-raw, format=RGB, width={K4_W}, height={K4_H}, "
            "framerate=30/1")
    n_max = CONFIG4_CHUNKS[0] * CONFIG4_GOP
    frames = np.concatenate([gradient_ball_frames(
        K4_H, K4_W, CONFIG4_GOP, s, device=dev).cpu().numpy()
        for s in range(0, n_max, CONFIG4_GOP)])

    def run(c, spatial, trace):
        desc = (f"cudahype codec=jpeg chunks={c} gop-size={CONFIG4_GOP} "
                f"spatial={spatial} device={dev}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ooms = torch.cuda.memory_stats().get("num_ooms", 0)
        n = c * CONFIG4_GOP
        (out, wall, traced), counts = _count_launches(
            lambda: _harness_run(desc, frames[:n], caps,
                                 trace=n if trace else 0))
        oom = torch.cuda.memory_stats().get("num_ooms", 0) > ooms
        return dict(desc=desc, out=[bytes(b.data) for b in out],
                    pts=[b.pts for b in out], wall=wall, traced=traced,
                    counts=counts, peak=torch.cuda.max_memory_allocated(),
                    oom=oom)

    c = CONFIG4_CHUNKS[0]
    probe = run(c, STRIPES, True)
    fits = not probe["oom"] and len(probe["out"]) == c * CONFIG4_GOP \
        and probe["peak"] < CONFIG4_PEAK_GIB * 2 ** 30
    print(f"16a C={c}: peak device memory {probe['peak'] / 2 ** 30:.2f} GiB"
          + (" (out of device memory)" if probe["oom"] else "") + "; "
          + (f"under {CONFIG4_PEAK_GIB} GiB: C={c}" if fits else
             f"not under {CONFIG4_PEAK_GIB} GiB of the 80: C="
             f"{CONFIG4_CHUNKS[1]}"), flush=True)
    if not fits:
        c = CONFIG4_CHUNKS[1]
        probe = run(c, STRIPES, True)
        _require(not probe["oom"], f"16a: C={c} ran out of device memory")
    n = c * CONFIG4_GOP
    _require(len(probe["out"]) == n, f"16a: {len(probe['out'])} of {n} "
             "frames")
    _require(probe["pts"] == [i * FRAME_NS for i in range(n)],
             "16a: frames out of order")
    flat = run(c, 1, True)
    for r_, what in ((probe, "the first run (traced; the process's first "
                      "4K dispatch)"), (flat, "traced")):
        busy, launches, busy_wall = r_["traced"]
        _report(f"16a {r_['desc']} ({what})", n, r_["wall"], busy, launches,
                c, r_["peak"], busy_wall)
        print(f"16a kernel launches {r_['counts']}", flush=True)
    for k in ("front_end", "pack_segments"):
        _require(probe["counts"][k] > 0, f"16a: {k} was not launched")
    walls = {1: [], STRIPES: []}
    for spatial in (1, STRIPES, STRIPES, 1):
        r_ = run(c, spatial, False)
        _require(r_["out"] == probe["out"], f"16a: {r_['desc']} gave other "
                 "JFIF")
        walls[spatial].append(r_["wall"])
    print("16a in turns (1, 2, 2, 1), 4K from host memory, one dispatch of "
          f"{c} chunks: " + "; ".join(
              f"spatial={k} {', '.join(f'{n / w:.1f}' for w in v)} frames/s"
              for k, v in walls.items()), flush=True)
    _require(flat["out"] == probe["out"],
             "16a: striped JFIF differ from spatial=1's")
    enc = JpegEncoder(quality=QUALITY, device=dev)
    worst = float("inf")
    for g in range(0, n, GOP):
        src = torch.from_numpy(frames[g:g + GOP]).to(dev)
        planes = [_edge_pad(src[..., k], K4_H, K4_W) for k in range(3)]
        worst = min(worst, _check_frames(
            lib, probe["out"][g:g + GOP],
            F.front_end(*planes, enc._qy_dev, enc._qc_dev), src, enc,
            f"16a frames {g}-{g + GOP - 1}", size=(K4_H, K4_W, K4_H, K4_W)))
    print(f"16a checks: {n} 4K frames through {STRIPES} stripes "
          f"byte-identical to spatial=1, each decoding to K1's "
          f"coefficients and equal to flu_jpeg_encode_scan; lowest PSNR "
          f"{worst:.2f} dB", flush=True)
    return dict(probe["counts"])


def _pan4k(dev):
    """16b's content: a seeded 4K texture (uniform noise smoothed by six
    wrapping 3x3 box passes on the card) panned PAN4K_STEP per frame,
    wrapping, as numpy frames."""
    import torch
    g = torch.Generator(device=dev).manual_seed(16)
    tex = torch.rand((1, 3, K4_H, K4_W), generator=g, device=dev) * 255
    for _ in range(6):
        tex = torch.nn.functional.avg_pool2d(torch.nn.functional.pad(
            tex, (1, 1, 1, 1), mode="circular"), 3, stride=1)
    tex = tex[0].permute(1, 2, 0).round().to(torch.uint8)
    return torch.stack([torch.roll(tex, (PAN4K_STEP[0] * i,
                                         PAN4K_STEP[1] * i), (0, 1))
                        for i in range(PAN4K_FRAMES)]).cpu().numpy()


def _same_side(u, v) -> bool:
    """Two frame records' vectors (or fwd, bwd and modes) are equal."""
    import numpy as np
    if u is None or v is None:
        return u is None and v is None
    if isinstance(u, tuple):
        return all(np.array_equal(x, y) for x, y in zip(u, v))
    return np.array_equal(u, v)


def _records_equal(a: bytes, b: bytes) -> bool:
    """Two chunks hold the same frame records (types, vectors, payloads);
    their headers may differ in the coded-size fields."""
    from flutpu_torch.codec.fvc import FvcDecoder
    (_, fa), (_, fb) = FvcDecoder.parse_chunk(a), FvcDecoder.parse_chunk(b)
    return len(fa) == len(fb) and all(
        x[0] == y[0] and x[2] == y[2] and _same_side(x[1], y[1])
        for x, y in zip(fa, fb))


def _require_same(a: bytes, b: bytes, label: str,
                  records: bool = False) -> None:
    """Two encodes of one chunk on the card: byte-identical (``records``:
    the same frame records, the headers may differ in the coded-size
    fields). The in-loop transform (K9) sums every block alone in the
    CPU's order, so batch, shard, stripe and engine change no bit. On a
    split, fails naming the first differing frame in coding order and
    what differs there."""
    from flutpu_torch.codec.fvc import FvcDecoder
    if _records_equal(a, b) if records else a == b:
        return
    (_, fa), (_, fb) = FvcDecoder.parse_chunk(a), FvcDecoder.parse_chunk(b)
    where = f"{len(fa)} against {len(fb)} frames, or the header"
    if len(fa) == len(fb):
        types = [f[0] for f in fa]
        order = ([i for i, t in enumerate(types) if t != 2]
                 + [i for i, t in enumerate(types) if t == 2])
        for i in order:
            x, y = fa[i], fb[i]
            what = ("its type" if x[0] != y[0] else
                    "its vectors or modes" if not _same_side(x[1], y[1])
                    else "its payload" if x[2] != y[2] else None)
            if what:
                where = f"frame {i} (coding order), in {what}"
                break
    _require(False, f"{label}: differs from the reference encode at "
             f"{where}")


def _hold_striped(dev, padded):
    """16b's kernels against their plain versions at 16b's shapes: one
    frame step of the pan's STRIPE_CHUNKS chunks (frames 1 on 0 of each)
    cut into STRIPES stripes, through the rounded-halo route with K3 and
    K4 (luma stripes of 1088 + 2 x 16 rows, chroma 544 + 2 x 8) and with
    their plain versions. The vectors equal but at float64-verified
    near-ties, each prediction exactly the whole-frame compensation of
    its vectors; K4's and the plain chroma route's equal bit for bit."""
    import torch
    from flutpu_torch.codec.ops import motion_kernels as M
    from flutpu_torch.codec.ops.colorspace import planes_to_i420
    r = SEARCH_RANGE
    idx = [ci * CHUNK + k for ci in range(STRIPE_CHUNKS) for k in (0, 1)]
    src = torch.from_numpy(padded[idx]).to(dev)
    y, cb, cr = (p.reshape(STRIPE_CHUNKS, 2, *p.shape[1:])
                 for p in planes_to_i420(*(src[..., k] for k in range(3))))

    def cut(p):
        hs = p.shape[-2] // STRIPES
        return [p[:, s * hs:(s + 1) * hs].contiguous()
                for s in range(STRIPES)]

    cur, prev = y[:, 1].contiguous(), y[:, 0].contiguous()
    mv_k, pred_k = M.motion_search_mc_striped(cut(cur), cut(prev), r)
    mv_p, pred_p = M.motion_search_mc_striped(
        cut(cur), cut(prev), r, search=M.motion_search_mc_plain)
    mv, pred = torch.cat(mv_k, 1), torch.cat(pred_k, 1)
    mvp, predp = torch.cat(mv_p, 1), torch.cat(pred_p, 1)
    for k in range(STRIPE_CHUNKS):
        _hold_search(f"16b stripes, chunk {k}", "motion_search_mc",
                     (mv[k], pred[k]), (mvp[k], None), cur[k], prev[k], r,
                     16, True, lambda p_, m: M.motion_compensate(p_, m, r))
        _require(torch.equal(predp[k].view(torch.int32),
                             M.motion_compensate(prev[k], mvp[k], r)
                             .view(torch.int32)),
                 f"16b stripes, chunk {k}: the plain route's prediction "
                 "differs from the compensation of its vectors")
    pcb, pcr = cb[:, 0].contiguous(), cr[:, 0].contiguous()
    got = M.chroma_mc_striped(cut(pcb), cut(pcr), mv_k, r)
    plain = M.chroma_mc_striped(cut(pcb), cut(pcr), mv_k, r,
                                chroma=M.chroma_mc_plain)
    whole = M.chroma_mc_plain(pcb, pcr, mv, r)
    for a, b, c in zip(got, plain, whole):
        _require(all(torch.equal(x, z) for x, z in zip(a, b))
                 and torch.equal(torch.cat(a, 1), c),
                 "chroma_mc (16b stripes) differs from its plain version")
    print(f"chroma_mc vs plain (16b stripes: {STRIPE_CHUNKS} chunks x "
          f"{STRIPES} stripes of {tuple(got[0][0].shape[-2:])} + "
          f"{M.halo_rows(r, cur.shape[-2] // STRIPES) // 2}-row halos): "
          "equal bit for bit, and to the unstriped compensation",
          flush=True)


def _config4_fvc(dev, lib):
    """16b: a 4K pan (PAN4K_STEP per frame) through ``cudahype
    codec=fvc-motion spatial=2 chunks=2 gop-size=8 search-range=7``, P
    only and with ``bframes=1``: header flags bit 4 (2160 rows coded as
    2176), >= 30 dB through FvcDecoder, vectors with dy != 0 on the
    macroblock rows at the stripe edge, K3 and K4 launched and K5 not;
    each chunk's frame records equal the ``spatial=1`` chunk's of the
    same frames padded to 2176 rows."""
    import numpy as np
    import torch
    from flutpu_torch.codec.fvc import FvcDecoder
    frames = _pan4k(dev)
    ph = -(-K4_H // (16 * STRIPES)) * 16 * STRIPES
    padded = np.concatenate([frames, np.repeat(frames[:, -1:], ph - K4_H,
                                               axis=1)], axis=1)
    _hold_striped(dev, padded)
    per = STRIPE_CHUNKS * CHUNK
    total = {}
    for props, bframes in (("", 0), (" bframes=1", 1)):
        outs = {}
        for spatial, src in ((1, padded), (STRIPES, frames)):
            h = src.shape[1]
            caps = (f"video/x-raw, format=RGB, width={K4_W}, height={h}, "
                    "framerate=30/1")
            desc = (f"cudahype codec=fvc-motion chunks={STRIPE_CHUNKS} "
                    f"gop-size={CHUNK} search-range={SEARCH_RANGE} "
                    f"spatial={spatial} device={dev}{props}")
            torch.cuda.reset_peak_memory_stats()
            (out, wall, (busy, launches, busy_wall)), counts = \
                _count_launches(lambda: _harness_run(
                    desc, src, caps, warm=src[:per], trace=per))
            _report(f"16b {desc} ({PAN4K_FRAMES} frames of a {K4_H}-row pan"
                    + ("" if spatial > 1 else f" padded to {h} rows")
                    + f" after one warm dispatch; the trace over the first "
                    f"{STRIPE_CHUNKS}-chunk dispatch)", PAN4K_FRAMES, wall,
                    busy, launches, STRIPE_CHUNKS,
                    torch.cuda.max_memory_allocated(), busy_wall)
            print(f"16b kernel launches (warm dispatch included) {counts}",
                  flush=True)
            outs[spatial] = [bytes(b.data) for b in out]
            if spatial > 1:
                for k in ("motion_search_mc", "chroma_mc", "pack_segments"):
                    _require(counts[k] > 0, f"16b{props}: {k} not launched")
                _require(counts["motion_search_mc_hier"] == 0,
                         f"16b{props}: K5 launched")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
        striped, flat = outs[STRIPES], outs[1]
        n_chunks = PAN4K_FRAMES // CHUNK
        _require(len(striped) == len(flat) == n_chunks,
                 f"16b{props}: {len(striped)} and {len(flat)} chunks")
        edge, moved = (ph // STRIPES) // 16, []
        for ci, (a, b) in enumerate(zip(striped, flat)):
            hdr, recs = FvcDecoder.parse_chunk(a)
            _require(hdr["flags"] & 16 and (hdr["coded_height"],
                                            hdr["coded_width"])
                     == (ph, K4_W) and hdr["height"] == K4_H,
                     f"16b{props} chunk {ci}: header {hdr}")
            _require(bool(hdr["flags"] & 32) == bool(bframes),
                     f"16b{props} chunk {ci}: flags bit 5")
            for t, mv, _ in recs:
                if t == 1:
                    moved.append(mv[edge - 1:edge + 1, :, 0] != 0)
            _require_same(a, b, f"16b{props} chunk {ci}", records=True)
        share = float(np.mean(np.concatenate([m.ravel() for m in moved])))
        _require(share > 0.5, f"16b{props}: only {share:.3f} of the "
                 "stripe-edge macroblocks moved vertically")
        worst, _, _ = _check_chunks(
            lib, striped, [frames[ci * CHUNK:(ci + 1) * CHUNK]
                           for ci in range(n_chunks)], f"16b{props}",
            size=(K4_H, K4_W), cpu_decode=False)
        print(f"16b checks{props}: {n_chunks} chunks with flags bit 4 "
              f"(coded {ph}x{K4_W}), each with the frame records of "
              f"spatial=1; {share:.3f} of the P macroblocks on rows "
              f"{edge - 1} and {edge} (the stripe edge) with dy != 0; "
              f"decode on the "
              f"card >= {worst:.2f} dB; scans equal flu_jpeg_encode_scan",
              flush=True)
    return total


def _shard_meshes(devices):
    """16c's meshes over ``devices`` (repeated where there are fewer)."""
    from flutpu_torch.parallel.mesh import ChunkSpatialMesh, deal_devices
    from flutpu_torch.parallel.mesh import make_chunk_mesh
    return (("2 shards", make_chunk_mesh(2, deal_devices(2, devices))),
            ("4 shards", make_chunk_mesh(4, deal_devices(4, devices))),
            ("ChunkSpatialMesh(2, 2)",
             ChunkSpatialMesh(2, 2, deal_devices(4, devices))))


def _shards_on_cards(dev):
    """16c: ``encode_chunks`` and ``FvcEncoder.encode_chunks_dispatch`` on
    meshes of 2 and 4 shards and a (2, 2) grid of one card (and of
    distinct cards where there are two or more) against one shard: K1's
    coefficients equal, FVC chunks byte-identical."""
    import torch
    from flutpu_torch.codec.fvc import FvcEncoder
    from flutpu_torch.codec.jpeg import JpegEncoder
    from flutpu_torch.codec.ops.testsrc import gradient_ball_frames
    from flutpu_torch.parallel.gop import encode_chunks
    from flutpu_torch.parallel.mesh import visible_devices
    c = 4
    frames = gradient_ball_frames(PH, PW, c * CHUNK, 0, device=dev)[
        :, :H, :W].reshape(c, CHUNK, H, W, 3)
    jenc = JpegEncoder(QUALITY, device=dev)
    enc = FvcEncoder(QUALITY, motion=True, device=dev)
    coefs = encode_chunks(frames, jenc._qy_dev, jenc._qc_dev)
    ref = enc.encode_chunks_finalize(enc.encode_chunks_dispatch(frames))
    sets = [("one card", [dev])]
    cards = visible_devices()
    if len(cards) >= 2:
        sets.append((f"{len(cards)} cards", list(cards)))
    print(f"16c runs on {' and on '.join(n for n, _ in sets)} "
          f"({len(cards)} visible)", flush=True)
    total = {}
    for set_name, devices in sets:
        for name, mesh in _shard_meshes(devices):
            spatial = mesh.spatial > 1
            got = encode_chunks(frames, jenc._qy_dev, jenc._qc_dev,
                                mesh=mesh, spatial=spatial)
            _require(all(torch.equal(a, b.to(a.device)) for a, b in
                         zip(coefs, got)),
                     f"16c {set_name} {name}: K1's coefficients differ")
            out, counts = _count_launches(lambda: enc.encode_chunks_finalize(
                enc.encode_chunks_dispatch(frames, mesh)))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            for ci, (a, b) in enumerate(zip(out, ref)):
                _require_same(a, b, f"16c {set_name} {name} chunk {ci}")
            print(f"16c {set_name}, {name}: K1 equal; {c} of {c} FVC "
                  f"chunks byte-identical to one shard; launches {counts}",
                  flush=True)
    return total


def _two_processes(dev):
    """16d: two ``tests/torch_multihost_worker.py`` processes on the card
    over a gloo group, each encoding its 4 of the 8 chunks in one
    dispatch: the stitched stream equals this process's encode of the same
    chunks at 4 per dispatch."""
    import importlib.util
    from flutpu_torch.parallel.multihost import ChunkAssignment, stitch_order
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_multihost_worker.py")
    spec = importlib.util.spec_from_file_location("torch_multihost_worker",
                                                  path)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    args = ("--motion", "--size", "544x960")
    t0 = time.perf_counter()
    pieces = worker.run_processes(str(dev), *args,
                                  timeout=300)
    wall = time.perf_counter() - t0
    _require(sorted(pieces) == list(range(worker.CHUNKS)),
             f"16d: chunks {sorted(pieces)}")
    stitched = stitch_order(list(pieces.items()))
    frames = worker.batch(544, 960)
    enc = worker.encoder(str(dev), motion=True)
    single = b"".join(b"".join(enc.encode_chunks_finalize(
        enc.encode_chunks_dispatch(frames[ChunkAssignment(
            p, 2, worker.CHUNKS).local_chunks()]))) for p in range(2))
    _require(stitched == single, "16d: the two processes' stitched stream "
             "differs from one process's")
    print(f"16d two worker processes on {dev} over gloo: {worker.CHUNKS} "
          f"chunks ({len(stitched)} bytes) stitched byte-identical to one "
          f"process at {worker.CHUNKS // 2} chunks per dispatch; {wall:.2f} "
          "s with the processes' start", flush=True)


def _compositor_vmap(dev):
    """16e: ``composite_instances_batch_vmap`` on 4 intervals of phase
    10b's kind of seeded tiles and tables (640x368, 16-instance cap)
    equal to ``composite_instances_batch``; launches and busy ms per call
    of each."""
    import numpy as np
    import torch
    from flutpu_torch.ttml.render import atlas as A
    from flutpu_torch.ttml.render.device import (
        composite_instances_batch, composite_instances_batch_vmap)
    rng = np.random.default_rng(10)
    tiles = [np.full((A.TILE_H, A.TILE_W), 255, np.uint8)] + [
        rng.integers(0, 256, (A.TILE_H, A.TILE_W), np.uint8)
        for _ in range(3)]
    k = 4
    ints = np.zeros((k, 16, 9), np.int32)
    cols = np.zeros((k, 16, 4), np.float32)
    for j in range(k):
        for i in range(12):
            ints[j, i] = (rng.integers(0, 4), rng.integers(-400, 640),
                          rng.integers(-100, 368),
                          rng.integers(1, A.TILE_W + 1),
                          rng.integers(1, A.TILE_H + 1),
                          rng.integers(-20, 320), rng.integers(-20, 184),
                          rng.integers(320, 670), rng.integers(184, 400))
            cols[j, i] = (*rng.random(3), rng.choice([1.0, 0.5,
                                                      rng.random()]))
    atlas = A.atlas_from_numpy(tiles, device=dev).device_array()
    res = {}
    for name, fn in (("batch_vmap", composite_instances_batch_vmap),
                     ("batch", composite_instances_batch)):
        fn(atlas, ints, cols, 368, 640)
        out, busy, launches = _traced(lambda: fn(atlas, ints, cols, 368, 640))
        res[name] = out
        print(f"16e composite_instances_{name}, {k} intervals of 16 "
              f"instances: {launches} device launches, "
              + ("busy not measured" if busy is None else
                 f"{busy[0]:.3f} ms busy") + " per call", flush=True)
    _require(torch.equal(res["batch_vmap"], res["batch"]),
             "16e: the batched-interval compositor differs")
    print(f"16e: pixel-identical ({int((res['batch'][..., 3] > 0).sum())} "
          "lit pixels)", flush=True)


# -- 17. the command-line tools and the examples ----------------------------

CLI_JPEG_FRAMES = 64
CLI_FVC_FRAMES = 32
CLI_CHILD_FRAMES = 32          # the child launch: the first 32 of 17a's 64
CLI_ERROR_SECS = 30            # a failing launch must exit within this
MAX_BATCH_DPSNR = 0.01         # fvc_batched: batched vs separate, dB
CHILD_TIMEOUT = 300


def _jpeg_line(n: int) -> str:
    return (f"videotestsrc num-buffers={n} pattern=ball width={W} "
            f"height={H} ! cudajpegenc batch-frames={GOP}")


def split_jfif(data: bytes):
    """The JFIF of an MJPEG file (each from its SOI to its EOI). (The
    tests use it too.)"""
    out = [b"\xff\xd8" + p for p in data.split(b"\xff\xd8")[1:]]
    _require(all(f.endswith(b"\xff\xd9") for f in out),
             "an MJPEG frame does not end in EOI")
    return out


def run_cli(dev, lib, lap):
    """Phase 17. Returns 17a's launch counts (the in-process entry point;
    17b and 17c run in child processes, whose counts stay there)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        counts, jfif = _cli_in_process(dev, lib, tmp, lap)
        _cli_children(tmp, jfif)
        lap("17b the module entry points (child processes)")
        _examples(tmp)
        lap("17c the seven examples (child processes)")
    print("17 kernel launches (17a, in process): "
          + ", ".join(f"{k} {counts[k]}" for k in (
              "front_end", "pack_segments", "motion_search_mc",
              "chroma_mc")), flush=True)
    return counts


def _launch(line: str):
    """``flutpu_torch.launch.main`` on one line in this process → wall
    seconds and the kernels' launch counts; a nonzero exit fails."""
    from flutpu_torch.launch import main as launch

    def run():
        t0 = time.perf_counter()
        rc = launch([line])
        _require(rc == 0, f"17a: launch exited {rc} on {line!r}")
        return time.perf_counter() - t0

    return _count_launches(run)


def _cli_in_process(dev, lib, tmp, lap):
    """17a → (the launch counts of its two lines, the 64 JFIF)."""
    import numpy as np
    import torch
    from flutpu_torch.codec.fvc import FvcDecoder
    from flutpu_torch.codec.jpeg import JpegEncoder, _edge_pad
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.core import parse_launch
    from flutpu_torch.core.elements import make_test_frame
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # JPEG: the launch line against the same line through appsink
    n = CLI_JPEG_FRAMES
    path = os.path.join(tmp, "a.mjpeg")
    wall, counts = _launch(f"{_jpeg_line(n)} ! filesink location={path}")
    add(counts)
    with open(path, "rb") as fh:
        jfif = split_jfif(fh.read())
    _require(len(jfif) == n, f"17a: the MJPEG file holds {len(jfif)} JFIF")
    _require(counts["front_end"] > 0 and counts["pack_segments"] > 0,
             f"17a JPEG: K1 and K2 must launch ({counts})")
    bufs, pipe_wall = _pipeline(parse_launch,
                                f"{_jpeg_line(n)} ! appsink name=out")
    _require([bytes(b.data) for b in bufs] == jfif,
             "17a: launch's JFIF differ from the element's through appsink")
    enc = JpegEncoder(quality=QUALITY, device=dev)
    worst = float("inf")
    for g0 in range(0, n, GOP):
        frames = torch.from_numpy(np.stack([
            make_test_frame("ball", W, H, i)
            for i in range(g0, g0 + GOP)])).to(dev)
        planes = [_edge_pad(frames[..., c], PH, PW) for c in range(3)]
        worst = min(worst, _check_frames(
            lib, jfif[g0:g0 + GOP], F.front_end(*planes, enc._qy_dev,
                                                enc._qc_dev),
            frames, enc, f"17a launch JPEG frames {g0}-{g0 + GOP - 1}"))
    print(f"17a launch {_jpeg_line(n)} ! filesink: {n} frames in "
          f"{wall:.3f} s = {n / wall:.1f} frames/s (the same line through "
          f"appsink: {pipe_wall:.3f} s = {n / pipe_wall:.1f}); {n} JFIF "
          f"byte-identical to appsink's, decoding to K1's coefficients, "
          f"lowest PSNR {worst:.2f} dB; launches {counts}", flush=True)

    # FVC motion through the launch line, read back by decode_stream
    n = CLI_FVC_FRAMES
    path = os.path.join(tmp, "b.fvc")
    wall, counts = _launch(
        f"videotestsrc num-buffers={n} pattern=ball width={W} height={H} "
        f"! cudafvcenc motion=true gop-size={CHUNK} ! filesink "
        f"location={path}")
    add(counts)
    for k in ("motion_search_mc", "chroma_mc", "pack_segments"):
        _require(counts[k] > 0, f"17a FVC: {k} was not launched")
    _require(counts["front_end"] == 0, "17a FVC: K1 launched")
    with open(path, "rb") as fh:
        stream = fh.read()
    src = np.stack([make_test_frame("ball", W, H, i) for i in range(n)])
    out = FvcDecoder(dev).decode_stream(stream)
    _require(out.shape == src.shape, f"17a FVC: decoded {out.shape}")
    low = min(_psnr(a, b) for a, b in zip(out, src))
    _require(low >= MIN_PSNR, f"17a FVC: PSNR {low:.2f} dB")
    chunks = FvcDecoder.split_stream(stream)
    _check_chunks(lib, chunks, [src[i:i + CHUNK]
                                for i in range(0, n, CHUNK)], "17a FVC")
    print(f"17a launch cudafvcenc motion=true gop-size={CHUNK} ! filesink: "
          f"{n} frames in {wall:.3f} s = {n / wall:.1f} frames/s, "
          f"{len(chunks)} chunks ({len(stream)} bytes); decode_stream "
          f"{out.shape[0]} frames, lowest PSNR {low:.2f} dB; launches "
          f"{counts}", flush=True)
    lap("17a launch JPEG, FVC")
    return total, jfif


def _children(tmp, cmds):
    """Run the python commands (argument lists) side by side from the
    repository root, output to files under ``tmp`` → [(exit code, stdout,
    stderr, seconds)]; a command past CHILD_TIMEOUT fails the run, and
    every process still running on the way out is killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    procs = []
    try:
        for k, cmd in enumerate(cmds):
            out = open(os.path.join(tmp, f"child{k}.out"), "w+")
            err = open(os.path.join(tmp, f"child{k}.err"), "w+")
            procs.append([subprocess.Popen([sys.executable, *cmd], cwd=root,
                                           env=env, stdout=out, stderr=err),
                          out, err, time.perf_counter(), None])
        t0 = time.perf_counter()
        while any(p[4] is None for p in procs):
            _require(time.perf_counter() - t0 < CHILD_TIMEOUT,
                     f"a child process ran past {CHILD_TIMEOUT} s: "
                     f"{[c for c, p in zip(cmds, procs) if p[4] is None]}")
            for p in procs:
                if p[4] is None and p[0].poll() is not None:
                    p[4] = time.perf_counter() - p[3]
            time.sleep(0.05)
        res = []
        for proc, out, err, _, secs in procs:
            out.seek(0)
            err.seek(0)
            res.append((proc.returncode, out.read(), err.read(), secs))
        return res
    finally:
        for proc, out, err, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


def _cli_children(tmp, jfif):
    """17b: the module entry points, each in a child process."""
    import torch
    from flutpu_torch.core import factories
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "child.mjpeg")
    count = torch.cuda.device_count()
    missing = (f"videotestsrc num-buffers=8 ! cudajpegenc "
               f"device=cuda:{count} ! fakesink")
    cmds = [["-m", "flutpu_torch.launch",
             f"{_jpeg_line(CLI_CHILD_FRAMES)} ! filesink location={path}"],
            ["-m", "flutpu_torch.launch", missing],
            ["-m", "flutpu_torch.inspect"],
            ["-m", "flutpu_torch.inspect", "--markdown"],
            ["-c", "import torch\n"
                   "from flutpu_torch.core import factories\n"
                   "from flutpu_torch.inspect import _markdown\n"
                   "_markdown(factories())\n"
                   "print(torch.cuda.is_initialized())"]]
    (rc_l, _, err_l, s_l), (rc_m, _, err_m, s_m), (rc_i, out_i, _, s_i), \
        (rc_md, out_md, _, s_md), (rc_c, out_c, err_c, s_c) = \
        _children(tmp, cmds)
    _require(rc_l == 0, f"17b: python -m flutpu_torch.launch exited {rc_l}: "
             f"{err_l[-2000:]}")
    with open(path, "rb") as fh:
        _require(fh.read() == b"".join(jfif[:CLI_CHILD_FRAMES]),
                 "17b: the child launch's bytes differ from 17a's")
    _require(rc_m == 1 and s_m < CLI_ERROR_SECS and "ERROR from" in err_m,
             f"17b: launch on cuda:{count} (no such card) exited {rc_m} "
             f"after {s_m:.1f} s: {err_m[-2000:]}")
    error = [ln for ln in err_m.splitlines() if ln.startswith("ERROR from")]
    names = [ln.split()[0] for ln in out_i.splitlines()]
    _require(rc_i == 0 and names == sorted(factories()) and len(names) == 28,
             f"17b: inspect listed {names}")
    with open(os.path.join(root, "docs", "ELEMENTS_TORCH.md")) as fh:
        _require(rc_md == 0 and out_md == fh.read(),
                 "17b: inspect --markdown differs from docs/ELEMENTS_TORCH.md")
    _require(rc_c == 0 and out_c.split() == ["False"],
             f"17b: building the reference initialised CUDA ({out_c!r}, "
             f"{err_c[-1000:]})")
    print(f"17b python -m flutpu_torch.launch, {CLI_CHILD_FRAMES} frames: "
          f"exit 0 in {s_l:.2f} s, the in-process bytes; on cuda:{count} (no "
          f"such card): exit 1 in {s_m:.2f} s, {error[0]!r}; "
          f"python -m flutpu_torch.inspect: 28 factories in {s_i:.2f} s; "
          f"--markdown equal to docs/ELEMENTS_TORCH.md in {s_md:.2f} s; the "
          f"reference built without a CUDA context "
          f"(torch.cuda.is_initialized() False) in {s_c:.2f} s", flush=True)


def png_rgb(data: bytes):
    """The (h, w, 3) uint8 pixels of an 8-bit RGB PNG with filter 0 on
    every row (what examples/torch/subtitle_burnin.py writes). (The
    tests use it too.)"""
    import struct
    import zlib
    import numpy as np
    _require(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG signature")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        _require(struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
                 == zlib.crc32(tag + body) & 0xFFFFFFFF, f"PNG {tag} CRC")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = ihdr[:2]
    _require(ihdr[2:4] == (8, 2), f"PNG header {ihdr}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    _require(not rows[:, 0].any(), "PNG row filters")
    return rows[:, 1:].reshape(h, w, 3)


def _examples(tmp):
    """17c: the seven examples at their defaults on the card, side by
    side in child processes."""
    import numpy as np
    import torch
    from flutpu_torch.core.elements import make_test_frame

    def ex(name, *args):
        return [os.path.join("examples", "torch", f"{name}.py"), *args]

    payload = bytes(range(256)) * 400
    local = os.path.join(tmp, "local.bin")
    with open(local, "wb") as fh:
        fh.write(payload)
    png = os.path.join(tmp, "burnin.png")
    names = ["encode_parallel", "fvc_batched", "fvc_motion", "inject_swap",
             "mesh_encode jpeg", "mesh_encode fvc-motion 2", "multidl",
             "subtitle_burnin"]
    with Loopback({"/remote.bin": payload}) as srv:
        res = dict(zip(names, _children(tmp, [
            ex("encode_parallel"), ex("fvc_batched"), ex("fvc_motion"),
            ex("inject_swap"),
            ex("mesh_encode", "jpeg", "--out", os.path.join(tmp, "m.avi")),
            ex("mesh_encode", "fvc-motion", "2", "--out",
               os.path.join(tmp, "m.fvc")),
            ex("multidl", f"file://{local}", srv.url("/remote.bin")),
            ex("subtitle_burnin", png)])))
    for name, (rc, out, err, secs) in res.items():
        _require(rc == 0, f"17c {name} exited {rc}: {err[-3000:]}")
        print(f"17c {name}: exit 0 in {secs:.2f} s; "
              + " | ".join(out.strip().splitlines()), flush=True)
    out = res["encode_parallel"][1]
    low = float(out.split("PSNR min/mean = ")[1].split("/")[0])
    _require(low >= MIN_PSNR, f"17c encode_parallel: PSNR {low} dB")
    out = res["inject_swap"][1]
    jpeg = int(out.split(" JPEG after the swap")[0].rsplit(" ", 1)[1])
    _require(jpeg > 0, "17c inject_swap: no JPEG after the swap")
    out = res["fvc_batched"][1]
    diffs = [float(ln.split("(difference ")[1].split(" dB")[0])
             for ln in out.splitlines() if "(difference " in ln]
    _require("byte-identical to separate dispatches: True" in out
             or (diffs and max(diffs) <= MAX_BATCH_DPSNR),
             f"17c fvc_batched: {out!r}")
    for name in ("mesh_encode jpeg", "mesh_encode fvc-motion 2"):
        out = res[name][1]
        _require("1-chunk encode of 2 frames" in out and float(
            out.split("last-frame psnr ")[1].split(" dB")[0]) >= MIN_PSNR,
            f"17c {name}: {out!r}")
    out = res["multidl"][1]
    _require(f"file://{local}: OK http=0 {len(payload)} bytes" in out
             and f"{srv.url('/remote.bin')}: OK http=200 {len(payload)} bytes"
             in out, f"17c multidl: {out!r}")
    with open(png, "rb") as fh:
        got = png_rgb(fh.read())
    src = make_test_frame("gradient", 640, 360, 0)
    _require(got.shape == src.shape, f"17c subtitle_burnin: {got.shape}")
    rows, cols = slice(int(360 * 0.78), int(360 * 0.96)), slice(64, 576)
    changed = int((got[rows, cols] != src[rows, cols]).any(-1).sum())
    top = slice(0, 180)
    _require(changed > 0 and np.array_equal(got[top], src[top]),
             "17c subtitle_burnin: the subtitle region is unchanged or "
             "the frame's top half differs")
    print(f"17c checks: encode_parallel lowest PSNR {low} dB, inject_swap "
          f"{jpeg} JPEG after the swap, fvc_batched "
          + ("byte-identical" if not diffs else
             f"within {max(diffs):.4f} dB") + f", mesh_encode fvc-motion 2 "
          f"on {torch.cuda.device_count()} card(s), multidl file:// and "
          f"loopback, the PNG's subtitle region changed at {changed} "
          "pixels",
          flush=True)


HOST_GOPS = 4                  # 18a: GOPs per arm, two in flight
HOST_CHUNKS = 2                # 18b: chunks per arm and configuration
MAX_PLANAR_DPSNR = 0.1         # 18c: planar vs per-block chunk, dB
PLANAR_STRIPES = (2, 4)        # 18c: row stripes of the striped chunks


def run_host_engine(dev, lib, lap):
    """Phase 18. Returns the launch counts of its main paths: the host
    arms of 18a and 18b, and 18c's planar chunk and ``encode_gop_scans``
    calls."""
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    add(_host_jpeg(dev, lib))
    lap("18a JPEG host engine")
    counts, per_block = _host_fvc(dev, lib)
    add(counts)
    lap("18b FVC host engine")
    add(_planar_and_pack(dev, lib, per_block))
    lap("18c planar, encode_gop_scans")
    return total


def _engines_in_flight(enc, items, dispatch, finalize):
    """``dispatch(item)`` of every item with two in flight, each finalized
    in order by ``finalize(handle)`` → (outputs, device ms per dispatch
    (CUDA events around it: the device's part, the coefficient planes'
    copy included on the host engine), ms per finalize after its copy
    landed (the host's part: the scan coder on the host engine, the
    segments' compaction on the device engine), wall seconds)."""
    host_ms = []

    def timed(handle):
        copy = handle[0]
        copy.arrays()                  # waits for this handle's copy only
        t0 = time.perf_counter()
        out = finalize(handle)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    outs, dev_ms, wall = _in_flight(lambda i: dispatch(items[i]), timed,
                                    len(items))
    return outs, dev_ms, sum(host_ms) / len(host_ms), wall


def _host_jpeg(dev, lib):
    """18a: a 16-frame 1080p gradient-ball GOP stream through
    ``JpegEncoder(engine="host")`` and ``engine="device"``, then
    ``cudajpegenc engine=host`` through a pipeline. Returns the host
    arms' launch counts."""
    from flutpu_torch import native
    from flutpu_torch.codec.jpeg import JpegEncoder
    from flutpu_torch.codec.ops import frontend as F
    from flutpu_torch.codec.ops.testsrc import gradient_ball_frames
    from flutpu_torch.core import parse_launch
    _require(native.get_lib() is not None, "18a: the native scan coder "
             "did not load")
    gops = [gradient_ball_frames(PH, PW, GOP, g * GOP, device=dev)[:, :H, :W]
            for g in range(HOST_GOPS)]
    arms = {e: JpegEncoder(QUALITY, engine=e, device=dev)
            for e in ("host", "device")}
    res, counts = {}, {}
    for name, enc in arms.items():
        enc.encode_gop(gops[0])        # warm: sizes, coder, thread pool
        res[name], counts[name] = _count_launches(lambda: _engines_in_flight(
            enc, gops, lambda g: enc.encode_gop_dispatch(g, H, W),
            enc.encode_gop_finalize))
    host, dev_arm = counts["host"], counts["device"]
    _require(host["front_end"] > 0, f"18a: K1 was not launched ({host})")
    for k in ("pack_segments", "pack_block_bits_fused", "pack_block_bits64"):
        _require(host[k] == 0, f"18a: {k} launched in the host arm ({host})")
    _require(dev_arm["pack_segments"] > 0, f"18a device arm: K2 ({dev_arm})")
    _require(res["host"][0] == res["device"][0], "18a: the host engine's "
             "JFIF differ from the device engine's")
    qy, qc = arms["host"]._qy_dev, arms["host"]._qc_dev
    low = _check_frames(lib, res["host"][0][0], F.front_end(
        *_edge_pad_planes(gops[0]), qy, qc), gops[0], arms["host"],
        "18a host GOP 0")
    for name in arms:
        _, dev_ms, host_ms, wall = res[name]
        print(f"18a JpegEncoder(engine={name!r}): {HOST_GOPS} GOPs x {GOP} "
              f"1080p frames, two in flight: "
              f"{HOST_GOPS * GOP / wall:.1f} frames/s, device "
              f"{dev_ms:.3f} ms per GOP (CUDA events), host "
              f"{host_ms:.3f} ms per GOP after the copy "
              f"({'native scan coder, 8 threads' if name == 'host' else 'segment compaction'}); "
              f"launches {counts[name]}", flush=True)
    desc = (f"videotestsrc num-buffers={GOP} pattern=ball width={W} "
            f"height={H} ! cudajpegenc batch-frames={GOP} engine={{}} ! "
            f"appsink name=out")
    (bufs, wall), pipe_counts = _count_launches(
        lambda: _pipeline(parse_launch, desc.format("host")))
    ref, _ = _pipeline(parse_launch, desc.format("device"))
    _require(len(bufs) == GOP and [bytes(b.data) for b in bufs]
             == [bytes(b.data) for b in ref], "18a: cudajpegenc engine=host "
             "differs from engine=device")
    _require(pipe_counts["front_end"] > 0 and pipe_counts["pack_segments"]
             == 0, f"18a pipeline launches {pipe_counts}")
    print(f"18a {desc.format('host')}: {GOP} frames in {wall:.3f} s, JFIF "
          f"byte-identical to engine=device, lowest PSNR {low:.2f} dB; "
          f"launches {pipe_counts}", flush=True)
    for k, v in pipe_counts.items():
        host[k] = host.get(k, 0) + v
    return host


def _edge_pad_planes(frames):
    """(F, H, W, 3) frames → their (r, g, b) planes edge-padded to the
    coded size."""
    from flutpu_torch.codec.jpeg import _edge_pad
    return [_edge_pad(frames[..., c], PH, PW) for c in range(3)]


def _host_fvc(dev, lib):
    """18b: 8-frame 1080p gradient-ball chunks, motion P (full search) and
    motion + B with hier, through ``FvcEncoder(engine="host")`` and
    ``engine="device"``. Returns (the host arms' launch counts, the P
    device arm's chunks with their sources)."""
    from flutpu_torch.codec.fvc import FvcEncoder
    from flutpu_torch.codec.ops.testsrc import (gradient_ball_frames,
                                                gradient_ball_planes)

    def src(ph, pw, n, start):
        return gradient_ball_planes(ph, pw, n, start, device=dev)

    chunks_in = [gradient_ball_frames(PH, PW, CHUNK, c * CHUNK,
                                      device=dev)[:, :H, :W]
                 for c in range(HOST_CHUNKS)]
    total, per_block = {}, None
    for label, kw, search in (("P", {}, "motion_search_mc"),
                              ("hier+B", {"hier": True, "bframes": 1},
                               "motion_search_mc_hier")):
        res, counts = {}, {}
        for engine in ("host", "device"):
            enc = FvcEncoder(QUALITY, motion=True, search_range=SEARCH_RANGE,
                             engine=engine, device=dev, **kw)
            enc.encode_chunk(chunks_in[0])     # warm
            res[engine], counts[engine] = _count_launches(
                lambda: _engines_in_flight(enc, chunks_in,
                                           enc.encode_chunk_dispatch,
                                           enc.encode_chunk_finalize))
        host = counts["host"]
        for k in (search, "chroma_mc"):
            _require(host[k] > 0, f"18b {label}: {k} was not launched "
                     f"({host})")
        for k in ("pack_segments", "pack_block_bits_fused",
                  "pack_block_bits64", "front_end"):
            _require(host[k] == 0, f"18b {label}: {k} launched in the host "
                     f"arm ({host})")
        _require(counts["device"]["pack_segments"] > 0,
                 f"18b {label} device arm: K2 ({counts['device']})")
        srcs = [c.cpu().numpy() for c in chunks_in]
        for ci, (a, b) in enumerate(zip(res["host"][0], res["device"][0])):
            _require_same(a, b, f"18b {label} chunk {ci}")
        # the source-fed batch: the host engine's one codec call and copy
        batched = {}
        for engine in ("host", "device"):
            enc = FvcEncoder(QUALITY, motion=True, search_range=SEARCH_RANGE,
                             engine=engine, device=dev, **kw)
            batched[engine], n = _count_launches(
                lambda: enc.encode_chunk_batch_finalize(
                    enc.encode_chunk_batch_dispatch_src(
                        src, 0, CHUNK, H, W, batch=HOST_CHUNKS)))
            if engine == "host":
                _require(n["pack_segments"] == 0 and n[search] > 0,
                         f"18b {label} host batch: launches {n}")
                host = {k: v + n[k] for k, v in host.items()}
        for ci, (a, b) in enumerate(zip(batched["host"], batched["device"])):
            _require_same(a, b, f"18b {label} host batch chunk {ci}")
        worst, _, _ = _check_chunks(lib, res["host"][0], srcs,
                                    f"18b {label} host", cpu_decode=False)
        for engine in ("host", "device"):
            _, dev_ms, host_ms, wall = res[engine]
            print(f"18b FvcEncoder({label}, engine={engine!r}): "
                  f"{HOST_CHUNKS} chunks x {CHUNK} 1080p frames, two in "
                  f"flight: {HOST_CHUNKS * CHUNK / wall:.1f} frames/s, "
                  f"device {dev_ms:.3f} ms per chunk (CUDA events), host "
                  f"{host_ms:.3f} ms per chunk after the copy; launches "
                  f"{counts[engine]}", flush=True)
        print(f"18b {label}: {HOST_CHUNKS} of {HOST_CHUNKS} chunks "
              f"byte-identical across the engines, also through "
              f"encode_chunk_batch_dispatch_src of {HOST_CHUNKS} chunks; "
              f"host chunks decode at >= {worst:.2f} dB", flush=True)
        for k, v in host.items():
            total[k] = total.get(k, 0) + v
        if label == "P":
            per_block = (res["device"][0][0], srcs[0])
    return total, per_block


def _planar_in_loop(enc, frames, chunk, stripes: int, dev, label: str):
    """18c: ``chunk``, ``enc``'s planar encode of the 1080p ``frames`` on
    ``stripes`` row stripes of the card, against the in-loop planes of
    the motion loop run on those stripes: the chunk's coefficients must
    be the loop's, and the decoder's reconstruction over the whole frame
    (full-height block-diagonal products) must equal the stripes' planes
    (stripe-height products) in every frame."""
    import numpy as np
    import torch
    from flutpu_torch.codec import fvc as FV
    from flutpu_torch.codec.decode import decode_scan_to_coefs
    qy, qc = enc._scan_coder._qy_dev, enc._scan_coder._qc_dev
    hs = PH // stripes
    parts = [tuple(p[:, s * hs:(s + 1) * hs] for p in _edge_pad_planes(
        frames)) for s in range(stripes)]
    y, cb, cr, _ = FV._stripes_in(parts if stripes > 1 else parts[0], hs,
                                  PW, stripes > 1)
    out, itypes, recs = FV._anchor_loop(y, cb, cr, qy, qc,
                                        FV._search_fn(False), SEARCH_RANGE,
                                        planar=True)
    loop = [FV._gather_rows(p, 2)[0].cpu().numpy() for p in zip(*out)]
    _, recs_in = FV.FvcDecoder.parse_chunk(chunk)
    coefs = [np.stack(c) for c in zip(*(
        decode_scan_to_coefs(p, PW // 8, PH // 8, PW // 16, PH // 16, True)
        for _, _, p in recs_in))]
    for k in range(3):
        _require(np.array_equal(coefs[k], loop[k]), f"18c {label}: the "
                 "chunk's coefficients are not the loop's")
    planes = FV.FvcDecoder._reconstruct_mc(
        *(torch.as_tensor(c, device=dev) for c in coefs),
        [m for _, m, _ in recs_in], qy, qc, planar=True)
    drift = max(float((torch.cat(rec, dim=-2)[0] - p[i]).abs().max())
                for i, frame in enumerate(recs)
                for rec, p in zip(frame, planes))
    _require(drift == 0.0, f"18c {label}: the decoder's planes differ from "
             f"the encoder's in-loop planes by up to {drift}")


def _planar_and_pack(dev, lib, per_block):
    """18c: an 8-frame 1080p motion chunk with ``planar = True`` (flags
    bit 3; the decoder rebuilds the encoder's in-loop planes exactly,
    also for a chunk coded on two row stripes; PSNR beside the per-block
    chunk ``per_block`` = (chunk, source)), and ``encode_gop_scans`` on
    the card, fused (K7) and not (K8a), against its plain version on all
    frames and whole scans. Returns the launch counts of both."""
    import torch
    from flutpu_torch.codec import fvc as FV
    from flutpu_torch.codec.jpeg import encode_gop_to_coefs
    from flutpu_torch.codec.ops import entropy_kernels as K
    from flutpu_torch.codec.ops.dct import plane_dct_planar
    from flutpu_torch.codec.ops.entropy import (_concat_blocks_v3,
                                                _mcu_blocks,
                                                _slot_tables_merged,
                                                encode_gop_scans, mcu_layout)
    from flutpu_torch.parallel.mesh import ChunkSpatialMesh
    chunk_pb, src = per_block
    frames = torch.from_numpy(src).to(dev)
    enc = FV.FvcEncoder(QUALITY, motion=True, search_range=SEARCH_RANGE,
                        device=dev)
    enc.planar = True
    chunk, counts = _count_launches(lambda: enc.encode_chunk(frames))
    for k in ("motion_search_mc", "chroma_mc", "pack_segments"):
        _require(counts[k] > 0, f"18c planar: {k} was not launched")
    _require(chunk[5] == 0x0b, f"18c planar: header flags {chunk[5]:#x}")
    _planar_in_loop(enc, frames, chunk, 1, dev, "planar")
    striped = {}
    for n in PLANAR_STRIPES:
        striped[n] = enc.encode_chunks_finalize(enc.encode_chunks_dispatch(
            frames[None], mesh=ChunkSpatialMesh(1, n, [dev] * n)))[0]
        _require(striped[n][5] == 0x0b, f"18c planar on {n} stripes: "
                 f"header flags {striped[n][5]:#x}")
        _planar_in_loop(enc, frames, striped[n], n, dev,
                        f"planar on {n} stripes")
    dec = FV.FvcDecoder(dev)
    p_planar = [_psnr(a, b) for a, b in zip(dec.decode_chunk(chunk)[0], src)]
    p_block = [_psnr(a, b) for a, b in zip(dec.decode_chunk(chunk_pb)[0],
                                           src)]
    d_psnr = max(abs(a - b) for a, b in zip(p_planar, p_block))
    _require(d_psnr <= MAX_PLANAR_DPSNR and min(p_planar) >= MIN_PSNR,
             f"18c planar: PSNR {min(p_planar):.2f} dB, {d_psnr:.4f} dB "
             "from the per-block chunk")
    # full fp32 whatever the TF32 setting, and the CPU's bits
    plane = frames[0, ..., 0].float()
    want = plane_dct_planar(plane.cpu())
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            _require(torch.equal(plane_dct_planar(plane).cpu(), want),
                     f"18c: the planar products on the card (TF32 {tf32}) "
                     "differ from the CPU's")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"18c planar chunk: flags {chunk[5]:#04x}, {len(chunk)} bytes "
          f"(per-block {len(chunk_pb)}; "
          + "; ".join(f"on {n} row stripes {len(c)}, "
                      + ("byte-identical" if c == chunk else "other bytes")
                      for n, c in striped.items())
          + "); FvcDecoder rebuilds the encoder's in-loop planes exactly "
          "in every frame, unstriped and striped; PSNR "
          f"{min(p_planar):.3f}-{max(p_planar):.3f} dB, at most "
          f"{d_psnr:.4f} dB from the per-block chunk's; the planar products "
          f"the CPU's bits with TF32 on and off; launches {counts}",
          flush=True)

    qy, qc = enc._scan_coder._qy_dev, enc._scan_coder._qc_dev
    coefs = encode_gop_to_coefs(frames, qy, qc, PH, PW)
    layout = mcu_layout(PW // 8, PH // 8, PW // 16, PH // 16, True)
    # the plain version, on the card: encode_gop_scans's stages with each
    # pack's plain PyTorch version, over every frame; the window holds
    # the longest scan whole
    mcu, comp = _mcu_blocks(*coefs, layout)
    f, b = mcu.shape[:2]
    flat, comp_flat = mcu.reshape(f * b, 64), comp.repeat(f)
    packs = {True: K.pack_block_bits_fused_plain(flat, comp_flat),
             False: K.pack_block_bits64_plain(*_slot_tables_merged(
                 flat, comp_flat))}
    words = -(-int(packs[True][1].view(f, b).to(torch.int64).sum(1).max())
              // 32)
    for fused, name in ((True, "pack_block_bits_fused"),
                        (False, "pack_block_bits64")):
        buf, nbits = packs[fused]
        want, want_bits = _concat_blocks_v3(buf.view(f, b, K.BLOCK_WORDS),
                                            nbits.view(f, b), words)
        (packed, bits), n = _count_launches(
            lambda: encode_gop_scans(*coefs, layout, words, fused=fused))
        _require(n[name] > 0, f"18c encode_gop_scans(fused={fused}): {name} "
                 f"was not launched ({n})")
        _require(int(bits.max()) <= words * 32, f"18c encode_gop_scans("
                 f"fused={fused}): a scan of {int(bits.max())} bits exceeds "
                 f"the {words}-word window")
        same = torch.equal(packed, want) and torch.equal(
            bits, want_bits.to(torch.int32))
        _require(same, f"18c encode_gop_scans(fused={fused}) differs from "
                 "its plain version")
        ms = _time_ms(lambda: encode_gop_scans(*coefs, layout, words,
                                               fused=fused), 5)
        print(f"18c encode_gop_scans(fused={fused}) on {CHUNK} 1080p "
              f"frames: words and bits of all {f} whole scans (up to "
              f"{int(bits.max())} bits, {words} words) equal to the plain "
              f"version, {ms:.3f} ms per call; launches {n}", flush=True)
        for k, v in n.items():
            counts[k] = counts.get(k, 0) + v
    return counts


#: phase 19: K9 against its plain version on the CPU, at the shapes the
#: in-loop transform meets
TRANSFORM_SHAPES = (
    ("1088x1920 luma, C = 1", (1, PH, PW)),
    ("1088x1920 luma, C = 8", (8, PH, PW)),
    ("544x960 chroma pair", (2, PH // 2, PW // 2)),
    # a 4K row stripe of config 4: 1088 rows and two 16-row halos
    ("1120-row stripe", (1120, 3840)),
    ("non-contiguous view", (PH, PW)),
    ("zigzag_unflatten coefficients", (1, PH, PW)),
)
#: device launches per 8-frame 1080p chunk before K9 (PERF.md §3)
LAUNCHES_BEFORE_K9 = {"P": 790, "hier+B": 1210}
GEMM_NAMES = ("gemm", "gemv", "cublas", "xmma", "cutlass")


def _bits_equal(a, b) -> bool:
    """Two float32 tensors (any devices) hold the same bits."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32).cpu(),
        b.contiguous().view(torch.int32).cpu())


def _transform_inputs(shape, label, seed, qy, dev):
    """Phase 19's inputs on the CPU and the card: a plane of samples in
    -255..255 with -0 among them (for the non-contiguous case a view of
    the middle columns of a wider plane), and the coefficients the IDCT
    takes (the DCT's with -0 among them, or the decoder's
    ``dequantize(zigzag_unflatten(q))``)."""
    import numpy as np
    import torch
    from flutpu_torch.codec.ops.quant import (dequantize, quantize,
                                              zigzag_flatten,
                                              zigzag_unflatten)
    from flutpu_torch.codec.ops.transform_kernels import block_dct_plain
    rng = np.random.default_rng(seed)
    wide = label.startswith("non-contiguous")
    full = (*shape[:-1], shape[-1] + 16) if wide else shape
    x = rng.uniform(-255, 255, full).astype(np.float32)
    x[rng.random(full) < 0.02] = -0.0
    x_cpu = torch.from_numpy(x)
    x_dev = x_cpu.to(dev)
    if wide:
        x_cpu, x_dev = x_cpu[..., 8:8 + shape[-1]], x_dev[..., 8:8 + shape[-1]]
    coefs = block_dct_plain(x_cpu)
    if label.startswith("zigzag"):
        q = zigzag_flatten(quantize(coefs, qy.cpu())).to(torch.int16)
        d_cpu, d_dev = (dequantize(zigzag_unflatten(t.to(torch.float32)), tab)
                        for t, tab in ((q, qy.cpu()), (q.to(dev), qy)))
    else:
        d_cpu = coefs.clone()
        d_cpu[torch.from_numpy(rng.random(tuple(coefs.shape)) < 0.02)] = -0.0
        d_dev = d_cpu.to(dev)
    return x_cpu, x_dev, d_cpu, d_dev


def run_transform(dev):
    """Phase 19: K9 (``block_dct``, ``block_idct``) against its plain
    version run on the CPU, bit for bit, at TRANSFORM_SHAPES, each timed
    beside the cuBLAS route it replaced (the plain version on the card),
    the plain CPU time and its byte bound; then phases 6 and 8's traces
    of 8-frame 1080p FVC P and hier+B chunks (``_print_busy``, 4 chunks
    in flight): busy ms and device launches per chunk beside those
    before K9, K9 in the trace and no GEMM. Returns the kernels-line
    records of K9 at the C = 1 luma shape."""
    import torch
    from flutpu_torch.codec.jpeg import JpegEncoder
    from flutpu_torch.codec.ops import transform_kernels as T
    from flutpu_torch.codec.ops.dct import _dct_on, blockize
    qy = JpegEncoder(QUALITY, device=dev)._qy_dev
    results = {}
    for i, (label, shape) in enumerate(TRANSFORM_SHAPES):
        x_cpu, x_dev, d_cpu, d_dev = _transform_inputs(shape, label, 19 + i,
                                                       qy, dev)
        n = x_cpu.numel()
        line = []
        for name, fn, plain, a_cpu, a_dev in (
                ("block_dct", T.block_dct, T.block_dct_plain, x_cpu, x_dev),
                ("block_idct", T.block_idct, T.block_idct_plain, d_cpu,
                 d_dev)):
            got = fn(a_dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain(a_cpu)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            _require(got.is_cuda and _bits_equal(got, want),
                     f"19 {label}: {name} differs from its plain version on "
                     "the CPU")
            ms = _time_ms(lambda: fn(a_dev), 20)
            route_ms = _time_ms(lambda: plain(a_dev), 10)
            # each sample read and written once, 4 bytes each; 2 products
            # of 8 multiply-adds per sample
            bound = _bound(8 * n, 32 * n)
            line.append(f"{name} {ms:.4f} ms (cuBLAS route {route_ms:.4f}, "
                        f"CPU plain {cpu_ms:.1f}, bound "
                        f"{bound['bound_ms']:.4f})")
            if i == 0:
                c = _dct_on(a_dev.device)
                blocks = blockize(a_dev).contiguous() if name == "block_dct" \
                    else a_dev.contiguous()
                lib_fn = ((lambda: c @ blocks @ c.T) if name == "block_dct"
                          else (lambda: c.T @ blocks @ c))
                results[name] = dict(max_abs_err=0, ms=ms, plain_ms=route_ms,
                                     library_ms=_time_ms(lib_fn, 10),
                                     **bound)
        print(f"19 {label} {tuple(shape)}: bit-identical to the plain version "
              f"on the CPU ({n} samples each way); " + "; ".join(line),
              flush=True)
    for name in ("block_dct", "block_idct"):
        r_ = results[name]
        print(f"19 {name} at 1088x1920 (the kernels line): kernel "
              f"{r_['ms']:.4f} ms, cuBLAS route (plain version on the card) "
              f"{r_['plain_ms']:.4f} ms, the two cuBLAS products alone "
              f"{r_['library_ms']:.4f} ms, bound {r_['bound_ms']:.4f} ms",
              flush=True)
    for label, key, phase in (("P", "FVC full-search P chunk", 6),
                              ("hier+B", "FVC hier+B chunk", 8)):
        _require(key in PER_CHUNK_BUSY, f"19 FVC {label}: phase {phase} "
                 "traced no device activity")
        busy, launches, names = PER_CHUNK_BUSY[key]
        gemm = sorted(k for k in names
                      if any(g in k.lower() for g in GEMM_NAMES))
        _require(not gemm, f"19 FVC {label}: GEMM kernels in the loop {gemm}")
        k9 = [sum(c for k, c in names.items() if kernel in k)
              for kernel in ("block_dct_kernel", "block_idct_kernel")]
        _require(min(k9) > 0, f"19 FVC {label}: K9 is not in phase {phase}'s "
                 "trace")
        print(f"19 FVC {label} chunk (8 frames, 1080p; phase {phase}'s trace "
              f"of 4 chunks in flight): {busy:.3f} ms busy and {launches:g} "
              f"device launches per chunk (before K9: ~"
              f"{LAUNCHES_BEFORE_K9[label]}); "
              f"K9 {k9[0]:g} + {k9[1]:g} launches per chunk; no GEMM in the "
              "chunk", flush=True)
    return results


if __name__ == "__main__":
    sys.exit(main())
