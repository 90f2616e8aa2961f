"""The plain reference's entropy stage: a baseline JPEG scan (ITU-T T.81:
MCU-interleaved 4:2:0, DC predicted per component, the Annex K.3 Huffman
tables, byte-stuffed, padded with one bits) coded with numpy, every
symbol of a frame at once.

It follows T.81 alone and imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

# ITU-T T.81 Annex K.3 (bits[1..16], values) per table
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _canonical(bits, vals):
    """T.81 C.2: the canonical code of each value → (codes[256],
    lengths[256])."""
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = code
            lengths[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


#: per component class (0 luma, 1 chroma): the DC and the AC table
_TABLES = [(_canonical(*_DC_LUMA), _canonical(*_AC_LUMA)),
           (_canonical(*_DC_CHROMA), _canonical(*_AC_CHROMA))]


def _bit_length(a: np.ndarray) -> np.ndarray:
    """Bits of |a| (0 for 0), for |a| < 2**24."""
    return np.frexp(np.abs(a).astype(np.float64))[1].astype(np.int64)


def _mcu_blocks(y, cb, cr):
    """(BH, BW, 64) zigzagged planes (chroma (BH/2, BW/2, 64)) → the
    blocks in scan order (Y00 Y01 Y10 Y11 Cb Cr per MCU) and each block's
    component (0 Y, 1 Cb, 2 Cr)."""
    mh, mw = y.shape[0] // 2, y.shape[1] // 2
    yb = y.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4) \
        .reshape(mh * mw, 4, 64)
    blocks = np.concatenate([yb, cb.reshape(mh * mw, 1, 64),
                             cr.reshape(mh * mw, 1, 64)], axis=1)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mh * mw)
    return blocks.reshape(-1, 64).astype(np.int64), comp


def _lookup(cls, which, sym):
    """Code and length of symbol ``sym`` in table ``which`` (0 DC, 1 AC)
    of each entry's component class ``cls``."""
    code = np.where(cls == 0, _TABLES[0][which][0][sym],
                    _TABLES[1][which][0][sym])
    length = np.where(cls == 0, _TABLES[0][which][1][sym],
                      _TABLES[1][which][1][sym])
    return code, length


def _magnitude_bits(v, size):
    """T.81 F.1.2.1: the ``size`` low bits of v, or of v - 1 for v < 0."""
    return np.where(v >= 0, v, v + (np.int64(1) << size) - 1)


def encode_scan(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> bytes:
    """One frame's 4:2:0 scan from its (BH, BW, 64) int16 zigzagged
    quantized coefficient planes."""
    blocks, comp = _mcu_blocks(y, cb, cr)
    n = blocks.shape[0]
    cls = (comp > 0).astype(np.int64)
    # DC: the difference from the previous block of the same component
    dc = blocks[:, 0]
    diff = np.empty_like(dc)
    for c in range(3):
        sel = np.nonzero(comp == c)[0]
        d = dc[sel]
        diff[sel] = d - np.concatenate([[0], d[:-1]])
    s = _bit_length(diff)
    code, length = _lookup(cls, 0, s)
    dc_val = (code << s) | _magnitude_bits(diff, s)
    dc_len = length + s

    # AC: each nonzero coefficient after its run of zeros (ZRL per 16)
    ac = blocks[:, 1:]
    rows, cols = np.nonzero(ac)
    k = cols + 1
    first = np.ones(rows.shape, bool)
    first[1:] = rows[1:] != rows[:-1]
    prev = np.concatenate([[0], k[:-1]])
    prev[first] = 0
    run = k - prev - 1
    zrl = run // 16
    v = ac[rows, cols]
    size = _bit_length(v)
    code, length = _lookup(cls[rows], 1, ((run % 16) << 4) | size)
    ac_val = (code << size) | _magnitude_bits(v, size)
    ac_len = length + size
    # EOB where the block's last coefficient is zero
    eob = ac[:, -1] == 0

    per_nz = zrl + 1
    count = 1 + np.bincount(rows, weights=per_nz, minlength=n) \
        .astype(np.int64) + eob
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    total = int(count.sum())
    val = np.zeros(total + 1, np.int64)
    ln = np.zeros(total + 1, np.int64)
    val[start] = dc_val
    ln[start] = dc_len
    incl = np.cumsum(per_nz)
    row_first = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=n))[:-1]])
    before = incl - per_nz        # symbols of the earlier nonzeros, all rows
    base = before[row_first[rows]] if rows.size else before
    pos = start[rows] + 1 + (incl - base) - 1
    val[pos] = ac_val
    ln[pos] = ac_len
    nz_zrl = zrl > 0
    if nz_zrl.any():
        reps = zrl[nz_zrl]
        first_zrl = (pos - zrl)[nz_zrl]
        offs = np.arange(int(reps.sum())) - np.repeat(
            np.cumsum(reps) - reps, reps)
        zpos = np.repeat(first_zrl, reps) + offs
        zcode, zlen = _lookup(np.repeat(cls[rows][nz_zrl], reps), 1,
                              np.full(zpos.shape, 0xF0, np.int64))
        val[zpos] = zcode
        ln[zpos] = zlen
    eob_rows = np.nonzero(eob)[0]
    ecode, elen = _lookup(cls[eob_rows], 1, np.zeros(eob_rows.shape,
                                                     np.int64))
    epos = start[eob_rows] + count[eob_rows] - 1
    val[epos] = ecode
    ln[epos] = elen
    # pad the last byte with one bits
    bits = int(ln[:total].sum())
    pad = (-bits) % 8
    val[total] = (1 << pad) - 1
    ln[total] = pad
    return _pack(val, ln)


def _pack(val: np.ndarray, ln: np.ndarray) -> bytes:
    """Symbols of at most 33 bits (value, length) → their concatenated
    bits, then 0x00 stuffed after every 0xFF."""
    start = np.cumsum(ln) - ln
    nbytes = int((start[-1] + ln[-1]) // 8)
    off = start % 8
    byte0 = start // 8
    word = val << (40 - off - ln)    # the symbol in a 5-byte window
    acc = np.zeros(nbytes + 5, np.float64)
    for j in range(5):
        part = (word >> (32 - 8 * j)) & 0xFF
        acc += np.bincount(byte0 + j, weights=part, minlength=nbytes + 5)
    out = acc[:nbytes].astype(np.uint8)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()
