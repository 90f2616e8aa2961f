"""Huffman packs (port of flutpu/codec/ops/entropy_pallas.py).

Four wrappers of the CUDA kernels in ``csrc/entropy_pack.cu``, each
replacing a Pallas TPU kernel:

- ``pack_segments`` (K2, ``pack_segments_fused``): baseline-JPEG Huffman
  coding of ``seg_g`` consecutive MCU-ordered blocks into one MSB-first
  bit segment (the segment layout);
- ``pack_block_bits_fused`` (K7, ``pack_block_bits_fused``): the same
  coding per block into its own 64-word buffer (the non-segment
  layout); its kernel runs K2's device routine (a lane per block, segments
  assembled in shared memory) at one block per segment;
- ``pack_block_bits64`` (K8a, ``pack_block_bits_pallas64``): placement
  of merged slot tables (slots of up to 64 bits) per block;
- ``pack_block_bits`` (K8b, ``pack_block_bits_pallas``): placement of
  32-bit slot tables per block. Both kernels stage a few consecutive
  blocks' rows of lengths per warp with 16-byte copies, give each block
  up to 32 lanes of at most 32 slots each, fetch the values of the
  nonzero lengths alone and assemble the blocks in shared memory, as K7
  does; at most ``MAX_SLOTS`` slots per block.

K7, K8a and K8b compute one function: for the same blocks they return
the same (buf, nbits). Each wrapper launches its kernel for CUDA tensors
(or raises), takes its ``*_plain`` version for CPU tensors, refuses any
other device, and counts its launches in ``.launches``. The plain
versions are the same functions in plain PyTorch, computed in int64
(torch on the CPU has no uint32 shifts, adds or compares); the card's
results must equal them bit for bit.

Words are returned as int32 tensors holding the uint32 bit pattern
(``.numpy().view(np.uint32)`` recovers the unsigned words).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ... import _build
from .constants import on_device

_ready_devices = set()
_init_lock = threading.Lock()

#: Huffman items per chunk of the plain versions (bounds their memory)
_PLAIN_MAX_ITEMS = 1 << 22
_ITEMS_PER_BLOCK = 128          # DC, (ZRL run, AC symbol) x 63, EOB
#: words of one block's buffer in the non-segment layout
BLOCK_WORDS = 64
#: slots per block the K8a/K8b kernels take (32 lanes of 32 slots)
MAX_SLOTS = 1024
#: the most bits one block codes to (``JpegEncoder.BLOCK_BITS_BOUND``)
BLOCK_BITS_BOUND = 1664
#: shared memory one CUDA block may hold on Hopper; in K2's and K7's
#: kernel the Huffman tables' words (2 x 16 DC + 2 x 256 AC) and a warp's
#: tile of the 32 blocks its lanes code (rows of 68 words)
_SMEM_BYTES = 232_448
_TABLE_WORDS = 2 * 16 + 2 * 256
_TILE_WORDS = 32 * 68


def _check_args(zz, comp, seg_g, seg_words) -> None:
    if zz.dim() != 2 or zz.shape[1] != 64 or zz.dtype != torch.int32:
        raise ValueError(f"zz must be (B, 64) int32, got {zz.dtype} "
                         f"{tuple(zz.shape)}")
    if comp.shape != (zz.shape[0],) or comp.dtype != torch.int32:
        raise ValueError("comp must be (B,) int32")
    if comp.device != zz.device:
        raise ValueError("zz and comp must lie on one device")
    if zz.shape[0] % seg_g:
        raise ValueError(f"B={zz.shape[0]} is not a multiple of seg_g={seg_g}")
    if seg_words < 1:
        raise ValueError("seg_words must be positive")


def staging_words(seg_g: int, seg_words: int) -> int:
    """Words of the shared-memory row in which K2's kernel assembles one
    segment: its buffer, or all that ``seg_g`` blocks can fill (one word
    more, as the kernel allocates it)."""
    return min(seg_words, -(-seg_g * BLOCK_BITS_BOUND // 32) + 1)


def warp_words(seg_g: int, seg_words: int) -> int:
    """Shared-memory words one warp of K2's kernel holds: the rows of the
    segments it codes at once (all that fit 32 lanes at a lane per block,
    else one), and its tile (``csrc/entropy_pack.cu``: ``row_stride``,
    ``segs_per_warp``)."""
    spw = 32 // seg_g if seg_g <= 32 else 1
    stride = -(-staging_words(seg_g, seg_words) // 4) * 4
    if spw > 1 and stride % 8 == 0:
        stride += 4
    return spw * stride + _TILE_WORDS


def _check_staging(seg_g: int, seg_words: int) -> None:
    """Raise where one warp's rows and tile and the tables do not fit a
    CUDA block's shared memory."""
    need = (_TABLE_WORDS + warp_words(seg_g, seg_words)) * 4
    if need > _SMEM_BYTES:
        raise ValueError(f"pack_segments: one warp's staging takes {need} "
                         f"bytes (seg_g={seg_g}, seg_words={seg_words}), "
                         f"more than the {_SMEM_BYTES} bytes of shared "
                         f"memory of a CUDA block")


def _pow2(n: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(n) << n


def _magnitude(v: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Bit length of |v|, capped at ``max_bits`` (the kernels' category)."""
    a = v.abs()
    size = torch.zeros_like(v)
    for i in range(max_bits):
        size += (a >= (1 << i)).to(v.dtype)
    return size


def _tables(device):
    from .entropy import _device_tables
    return tuple(on_device(("huffman", i), t, device, torch.int64)
                 for i, t in enumerate(_device_tables()))


def _block_items(z: torch.Tensor, comp: torch.Tensor, tables):
    """Per-block Huffman items in stream order: (lens, vals) int64
    (B, 128) — DC, then (ZRL run, AC symbol) per AC position, then EOB.
    Each value holds exactly its length's bits (≤ 33)."""
    dc_code, dc_len, ac_code, ac_len = tables
    t = (comp == 1).long()
    live = comp >= 0
    zero = torch.zeros((), dtype=torch.int64, device=z.device)

    diff = z[:, 0]
    dsize = _magnitude(diff, 12)
    dextra = torch.where(diff < 0, diff + _pow2(dsize) - 1, diff) \
        & (_pow2(dsize) - 1)
    dc_l = torch.where(live, dc_len[t, dsize] + dsize, zero)
    dc_v = (dc_code[t, dsize] << dsize) | dextra

    ac = z[:, 1:]
    nz = ac != 0
    pos = torch.arange(1, 64, device=z.device)
    last_incl = torch.cummax(torch.where(nz, pos, zero), dim=1).values
    prev = torch.cat([torch.zeros_like(last_incl[:, :1]), last_incl[:, :-1]],
                     dim=1)
    run = pos - prev - 1
    asize = _magnitude(ac, 11)
    sym = ((run & 15) << 4) | asize
    tt = t[:, None].expand_as(sym)
    aextra = torch.where(ac < 0, ac + _pow2(asize) - 1, ac) \
        & (_pow2(asize) - 1)
    on = nz & live[:, None]
    ac_l = torch.where(on, ac_len[tt, sym] + asize, zero)
    ac_v = (ac_code[tt, sym] << asize) | aextra

    zrl_n = torch.where(on, run >> 4, zero)
    zl = ac_len[t, 0xF0][:, None]
    zc = ac_code[t, 0xF0][:, None]
    zrl_l = zrl_n * zl
    zrl_v = torch.zeros_like(zrl_l)
    for i in range(3):
        zrl_v = zrl_v | torch.where(zrl_n > i, zc << (i * zl), zero)

    eob = live & (last_incl[:, -1] < 63)
    eob_l = torch.where(eob, ac_len[t, 0x00], zero)
    eob_v = ac_code[t, 0x00]

    b = z.shape[0]
    lens = torch.cat([dc_l[:, None],
                      torch.stack([zrl_l, ac_l], dim=2).reshape(b, 126),
                      eob_l[:, None]], dim=1)
    vals = torch.cat([dc_v[:, None],
                      torch.stack([zrl_v, ac_v], dim=2).reshape(b, 126),
                      eob_v[:, None]], dim=1)
    return lens, torch.where(lens > 0, vals, zero)


def _place(lens: torch.Tensor, vals: torch.Tensor, seg_words: int):
    """Concatenate each row's items MSB-first into ``seg_words`` 32-bit
    words. Items span at most two words (offset%32 + length ≤ 64);
    disjoint bit ranges make the OR an exact int64 add. Returns
    (words (N, seg_words) int64 in [0, 2^32), bits (N,) int64)."""
    n, m = lens.shape
    ends = lens.cumsum(dim=1)
    starts = ends - lens
    q = starts & 31
    widx = starts >> 5
    e = q + lens
    two = e > 32
    sh_hi = torch.where(two, e - 32, torch.zeros_like(e))
    sh_lo = torch.where(two, torch.zeros_like(e), 32 - e)
    w0 = torch.where(two, vals >> sh_hi, vals << sh_lo)
    w1 = torch.where(two, (vals & (_pow2(sh_hi) - 1)) << (64 - e).clamp(max=63),
                     torch.zeros_like(vals))
    c = seg_words
    junk = torch.full_like(widx, c)
    col0 = torch.where(widx < c, widx, junk)
    col1 = torch.where(widx + 1 < c, widx + 1, junk)
    base = torch.arange(n, device=lens.device)[:, None] * (c + 1)
    buf = torch.zeros(n * (c + 1), dtype=torch.int64, device=lens.device)
    buf.index_add_(0, (base + col0).reshape(-1), w0.reshape(-1))
    buf.index_add_(0, (base + col1).reshape(-1), w1.reshape(-1))
    return buf.view(n, c + 1)[:, :c], ends[:, -1]


def _as_word_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensor of the same bit pattern."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words) \
        .to(torch.int32)


def _place_rows(items, n_rows: int, items_per_row: int, words: int,
                device):
    """``_place`` over rows in chunks of about ``_PLAIN_MAX_ITEMS`` items:
    ``items(r0, r1)`` gives rows [r0, r1)'s (lens, vals) int64, values
    holding exactly their length's bits (≤ 32). Returns (words (n_rows,
    words) int32 bit patterns, bits (n_rows,) int32)."""
    chunk = max(1, _PLAIN_MAX_ITEMS // items_per_row)
    bufs, bits = [], []
    for r0 in range(0, n_rows, chunk):
        w, nb = _place(*items(r0, min(n_rows, r0 + chunk)), words)
        bufs.append(_as_word_bits(w))
        bits.append(nb.to(torch.int32))
    if not bufs:
        return (torch.zeros((0, words), dtype=torch.int32, device=device),
                torch.zeros((0,), dtype=torch.int32, device=device))
    return torch.cat(bufs), torch.cat(bits)


def pack_segments_plain(zz: torch.Tensor, comp: torch.Tensor, seg_g: int = 16,
                        seg_words: int = 64):
    """Plain PyTorch version of the segment pack kernel (int64 math).
    Same contract as ``pack_segments``."""
    _check_args(zz, comp, seg_g, seg_words)
    tables = _tables(zz.device)

    def items(s0, s1):
        lens, vals = _block_items(zz[s0 * seg_g:s1 * seg_g].to(torch.int64),
                                  comp[s0 * seg_g:s1 * seg_g], tables)
        return lens.reshape(s1 - s0, -1), vals.reshape(s1 - s0, -1)

    return _place_rows(items, zz.shape[0] // seg_g, seg_g * _ITEMS_PER_BLOCK,
                       seg_words, zz.device)


def pack_block_bits_fused_plain(zz: torch.Tensor, comp: torch.Tensor):
    """Plain PyTorch version of K7: the segment pack at one block per
    segment and ``BLOCK_WORDS`` words. Same contract as
    ``pack_block_bits_fused``."""
    return pack_segments_plain(zz, comp, 1, BLOCK_WORDS)


def _check_slots(lens: torch.Tensor, *vals: torch.Tensor) -> None:
    if lens.dim() != 2 or lens.dtype != torch.int32:
        raise ValueError(f"lens must be (B, S) int32, got {lens.dtype} "
                         f"{tuple(lens.shape)}")
    for v in vals:
        if v.shape != lens.shape or v.dtype != torch.int32:
            raise ValueError(f"slot values must be {tuple(lens.shape)} int32 "
                             f"like lens, got {v.dtype} {tuple(v.shape)}")
        if v.device != lens.device:
            raise ValueError("slot tables must lie on one device")


def _low_bits(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The low ``n`` (0..32) bits of int32 bit patterns, as int64."""
    return (v.to(torch.int64) & 0xFFFFFFFF) & ((1 << n) - 1)


def pack_block_bits64_plain(lens: torch.Tensor, his: torch.Tensor,
                            los: torch.Tensor):
    """Plain PyTorch version of K8a: each merged slot splits into its
    high ``len - 32`` bits (from ``his``) and its low bits (from ``los``),
    two items of at most 32 bits, placed in order. Same contract as
    ``pack_block_bits64``."""
    _check_slots(lens, his, los)

    def items(r0, r1):
        n = lens[r0:r1].to(torch.int64)
        n_hi, n_lo = (n - 32).clamp(min=0), n.clamp(max=32)
        b = r1 - r0
        return (torch.stack([n_hi, n_lo], dim=2).reshape(b, -1),
                torch.stack([_low_bits(his[r0:r1], n_hi),
                             _low_bits(los[r0:r1], n_lo)], dim=2)
                .reshape(b, -1))

    return _place_rows(items, lens.shape[0], 2 * lens.shape[1], BLOCK_WORDS,
                       lens.device)


def pack_block_bits_plain(lens: torch.Tensor, vals: torch.Tensor):
    """Plain PyTorch version of K8b: the slots (each at most 32 bits)
    placed in order. Same contract as ``pack_block_bits``."""
    _check_slots(lens, vals)

    def items(r0, r1):
        n = lens[r0:r1].to(torch.int64)
        return n, _low_bits(vals[r0:r1], n)

    return _place_rows(items, lens.shape[0], lens.shape[1], BLOCK_WORDS,
                       lens.device)


def _init_device(lib, device: torch.device) -> None:
    """Upload the Huffman tables to ``device`` once. Several threads may
    launch first at the same moment: one uploads, the others wait for it,
    and none launches before the tables are there."""
    if device in _ready_devices:
        return
    with _init_lock:
        if device not in _ready_devices:
            _upload_tables(lib)
            _ready_devices.add(device)


def _upload_tables(lib) -> None:
    from .entropy import _device_tables
    dc_code, dc_len, ac_code, ac_len = _device_tables()
    dc = np.ascontiguousarray(((dc_len[:, :16].astype(np.uint32) << 16)
                               | dc_code[:, :16].astype(np.uint32)))
    ac = np.ascontiguousarray(((ac_len.astype(np.uint32) << 16)
                               | ac_code.astype(np.uint32)))
    _build.check(lib.flu_pack_init(dc.ctypes.data_as(ctypes.c_void_p),
                                   ac.ctypes.data_as(ctypes.c_void_p)),
                 "pack_segments tables")


def _device_of(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _outputs(rows: int, words: int, device):
    return (torch.empty((rows, words), dtype=torch.int32, device=device),
            torch.empty((rows,), dtype=torch.int32, device=device))


def _launch(wrapper, entry: str, device, *args, tables: bool = False) -> None:
    """Call a C entry of the kernel library on ``device``'s current
    stream (the stream is the last argument), after uploading the Huffman
    tables where the kernel reads them; raise on a CUDA error, else count
    the launch on ``wrapper``."""
    lib = _build.load()
    with torch.cuda.device(device):
        if tables:
            _init_device(lib, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(getattr(lib, entry)(*args, stream),
                     f"{wrapper.__name__} launch")
    _build.count_launch(wrapper)


def _launch_pack(wrapper, entry: str, zz, comp, seg_g: int, seg_words: int,
                 *shape: int):
    """The Huffman pack ``entry`` (K2 with ``shape`` = (seg_g, seg_words),
    K7 with none: the entry's arguments after the segment count) over
    (zz, comp), counted on ``wrapper``; no launch for no segments."""
    _check_args(zz, comp, seg_g, seg_words)
    _check_staging(seg_g, seg_words)
    zz = zz.contiguous()
    comp = comp.contiguous()
    s_count = zz.shape[0] // seg_g
    buf, bits = _outputs(s_count, seg_words, zz.device)
    if s_count:
        _launch(wrapper, entry, zz.device, zz.data_ptr(), comp.data_ptr(),
                buf.data_ptr(), bits.data_ptr(), s_count, *shape,
                tables=True)
    return buf, bits


def pack_segments(zz: torch.Tensor, comp: torch.Tensor, seg_g: int = 16,
                  seg_words: int = 64):
    """(B, 64) int32 DC-diffed MCU-ordered coefficients + (B,) int32 comp
    flags (0 luma, 1 chroma, -1 padding block emitting nothing) →
    (segbuf (S, seg_words) int32 words MSB-first, segbits (S,) int32),
    S = B / seg_g; blocks [s*seg_g, (s+1)*seg_g) concatenate into segment
    s. ``segbits`` counts every bit, also past ``seg_words * 32``; the
    buffer holds the first ``seg_words`` words. CUDA tensors launch the
    kernel on the current stream (``ValueError`` where one warp's staging,
    ``warp_words``, does not fit a CUDA block's shared memory: ``seg_g``
    above 1,065 with as many words); CPU tensors take
    ``pack_segments_plain``."""
    if _device_of("pack_segments", zz) == "cpu":
        return pack_segments_plain(zz, comp, seg_g, seg_words)
    return _launch_pack(pack_segments, "flu_pack_segments", zz, comp, seg_g,
                        seg_words, seg_g, seg_words)


def pack_block_bits_fused(zz: torch.Tensor, comp: torch.Tensor):
    """(B, 64) int32 DC-diffed MCU-ordered coefficients + (B,) int32 comp
    flags (0 luma, 1 chroma) → (buf (B, 64) int32 words MSB-first, nbits
    (B,) int32): each block Huffman-coded into its own buffer, every word
    written, bits past ``nbits`` zero. CUDA tensors launch K7 (K2's
    device routine at one block per segment); CPU tensors take
    ``pack_block_bits_fused_plain``."""
    if _device_of("pack_block_bits_fused", zz) == "cpu":
        return pack_block_bits_fused_plain(zz, comp)
    return _launch_pack(pack_block_bits_fused, "flu_pack_blocks", zz, comp,
                        1, BLOCK_WORDS)


def _launch_slots(wrapper, entry: str, lens: torch.Tensor,
                  *vals: torch.Tensor):
    """K8a's or K8b's kernel ``entry`` over the slot tables; no launch for
    no blocks."""
    _check_slots(lens, *vals)
    b, s = lens.shape
    if b and not 1 <= s <= MAX_SLOTS:
        raise ValueError(f"{wrapper.__name__}: the kernel takes 1..{MAX_SLOTS}"
                         f" slots per block, got {s}")
    # the kernels stage whole spans 16 bytes at a time; a view may start
    # anywhere
    tables = [t.contiguous() for t in (lens, *vals)]
    lens, *vals = [t.clone() if t.data_ptr() % 16 else t for t in tables]
    buf, nbits = _outputs(b, BLOCK_WORDS, lens.device)
    if b:
        _launch(wrapper, entry, lens.device, lens.data_ptr(),
                *(v.data_ptr() for v in vals), buf.data_ptr(),
                nbits.data_ptr(), b, s)
    return buf, nbits


def pack_block_bits64(lens: torch.Tensor, his: torch.Tensor,
                      los: torch.Tensor):
    """Merged slot tables (B, S) int32: ``lens`` (0..64), and the slot
    values as the low ``len`` bits of (hi << 32) | lo, hi and lo as
    uint32 bit patterns → (buf (B, 64) int32 words MSB-first, nbits (B,)
    int32), the same as ``pack_block_bits_fused`` for the blocks the
    tables come from. CUDA tensors launch the kernel (``ValueError``
    past ``MAX_SLOTS`` slots); CPU tensors take
    ``pack_block_bits64_plain``."""
    if _device_of("pack_block_bits64", lens) == "cpu":
        return pack_block_bits64_plain(lens, his, los)
    return _launch_slots(pack_block_bits64, "flu_pack_slots64", lens, his,
                         los)


def pack_block_bits(lens: torch.Tensor, vals: torch.Tensor):
    """32-bit slot tables (B, S) int32: ``lens`` (0..32) and values (the
    low ``len`` bits count) → (buf (B, 64) int32 words MSB-first, nbits
    (B,) int32), as ``pack_block_bits64``. CUDA tensors launch the
    kernel (``ValueError`` past ``MAX_SLOTS`` slots); CPU tensors take
    ``pack_block_bits_plain``."""
    if _device_of("pack_block_bits", lens) == "cpu":
        return pack_block_bits_plain(lens, vals)
    return _launch_slots(pack_block_bits, "flu_pack_slots32", lens, vals)


#: kernel launches since the count was last set to 0
pack_segments.launches = 0
pack_block_bits_fused.launches = 0
pack_block_bits64.launches = 0
pack_block_bits.launches = 0
