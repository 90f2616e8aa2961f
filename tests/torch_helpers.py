"""Shared pieces of the flutpu_torch tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA device, with fp32 matmuls in full precision; skips
    the test where there is no card. Decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def rand_planes(f=2, h=64, w=256, seed=0):
    """Three random uint8 (f, h, w) planes as numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (f, h, w), np.uint8) for _ in range(3))


def sparse_coefs(f=2, ybh=8, ybw=12, seed=0, dense=False):
    """Random sparse zigzagged int16 coefficient planes (y, cb, cr) with
    4:2:0 geometry, as numpy."""
    rng = np.random.default_rng(seed)

    def sparse(shape):
        a = rng.integers(-40, 40, size=shape).astype(np.int16)
        a = np.where(rng.random(shape) < (0.3 if dense else 0.08), a, 0)
        a[..., 0] = rng.integers(-200, 200, size=shape[:-1])
        return a.astype(np.int16)

    return (sparse((f, ybh, ybw, 64)), sparse((f, ybh // 2, ybw // 2, 64)),
            sparse((f, ybh // 2, ybw // 2, 64)))


def pack_edge_rows() -> np.ndarray:
    """DC-diffed blocks (int32, 64 each) that reach every rule of the
    Huffman packs and the seams a kernel on 32 lanes can split them at: DC
    |diff| 2047, 2048 and 4095 (4095 at the size-12 cap), AC |v| 1023,
    1024 and 2047 (2047 at the size-11 cap), zero runs of 15, 16, 31, 47
    and 48 before a nonzero (0 to 3 ZRLs) from the DC and from another
    nonzero, a nonzero at position 63 (no EOB) alone and after others,
    all-zero AC, 33, 40 and 63 nonzeros (more than a warp's lanes), and
    nonzeros on both sides of position 32 only."""
    rows = []

    def row(dc=0, **at):
        r = np.zeros(64, np.int32)
        r[0] = dc
        for p, v in at.items():
            r[int(p[1:])] = v
        rows.append(r)

    for dc in (2047, -2047, 2048, -2048, 4095, -4095, 0, 1, -1):
        row(dc)                                   # all-zero AC
    row(5, p1=1023, p2=-1023, p3=1024, p4=-1024, p5=2047, p6=-2047)
    row(-3, p62=1024, p63=-2047)
    for run in (15, 16, 31, 47, 48):
        row(7, **{f"p{1 + run}": -2})             # from the DC
        row(-7, **{f"p{3}": 1, f"p{4 + run}": 300})  # from a nonzero
    row(0, p63=-3)                                # three ZRLs, no EOB
    row(9, p1=1, p31=2, p32=-3, p63=4)            # no EOB after others
    row(1, p31=5, p32=-6)                         # the halves' seam
    row(2, p33=1)                                 # a run across the seam
    rng = np.random.default_rng(17)
    for n in (33, 40, 63):
        r = np.zeros(64, np.int32)
        r[0] = -100
        pos = np.sort(rng.choice(np.arange(1, 64), n, replace=False))
        r[pos] = rng.choice([-1, 1], n) * rng.integers(1, 2048, n)
        rows.append(r)
    sign = np.where(np.arange(64) % 2, -1, 1)
    rows.append(np.arange(1, 65, dtype=np.int32) * sign * 31)  # every size
    return np.stack(rows)


def pack_edge_blocks(n_segs: int, seg_g: int, seed: int = 0,
                     padding: bool = True):
    """(zz (n_segs * seg_g, 64) int32, comp int32) for the segment pack:
    ``pack_edge_rows`` first, then random blocks of mixed density (DC in
    ±4095, AC mostly small with some up to ±2047), on a 4:2:0 flag
    pattern (0 luma, 1 chroma). With ``padding`` the blocks that end the
    second-to-last segment (past its first) and the whole last segment are
    padding blocks (comp -1, all zero), as the encoder pads a frame."""
    rng = np.random.default_rng(seed)
    n = n_segs * seg_g
    density = rng.choice([0.0, 0.03, 0.1, 0.4, 0.9], n)[:, None]
    small = rng.integers(-40, 41, (n, 64))
    large = rng.integers(-2047, 2048, (n, 64))
    ac = np.where(rng.random((n, 64)) < 0.05, large, small)
    zz = np.where(rng.random((n, 64)) < density, ac, 0).astype(np.int32)
    zz[:, 0] = rng.integers(-4095, 4096, n)
    edge = pack_edge_rows()
    k = min(n, len(edge))
    zz[:k] = edge[:k]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 1], np.int32), n // 6 + 1)[:n]
    if padding and n_segs >= 2:
        last = (n_segs - 1) * seg_g
        half = last - seg_g + (seg_g + 1) // 2
        zz[half:], comp[half:] = 0, -1
    return zz, comp


def slot_tables(b: int, s: int, wide: bool, seed: int = 0,
                garbage: bool = False):
    """Hand-made slot tables, not made from blocks, as (B, S) int32 numpy
    arrays: ``(lens, his, los)`` for K8a (``wide``: lengths 0..64, the
    value the low ``len`` bits of (hi << 32) | lo) or ``(lens, vals)`` for
    K8b (lengths 0..32). Rows of every density (empty, sparse, dense,
    full), the lengths 1, 31, 32 (and 33, 63, 64 for K8a) on row 0, and,
    where S allows, rows whose bits pass 1664 (row 1), stop exactly at
    2048 (row 2) and pass 2048 in the middle of a slot (row 3 and every
    full row). Values hold exactly their length's bits; with ``garbage``
    the bits above it are random too (the port masks them, flutpu's
    kernels take none)."""
    rng = np.random.default_rng(seed)
    top = 64 if wide else 32
    density = rng.choice([0.0, 0.05, 0.3, 1.0], b)[:, None]
    lens = np.where(rng.random((b, s)) < density,
                    rng.integers(1, top + 1, (b, s)), 0)
    edge = [1, 31, 32, 33, 63, 64] if wide else [1, 31, 32]
    if b > 0:
        lens[0] = np.resize(edge, s)
    for row, n, tail in ((1, 1728 // top, ()), (2, 2048 // top, ()),
                         (3, 2048 // top - 1, (top - 1, top))):
        if row < b and s >= n + 2:
            lens[row] = 0
            lens[row, :n] = top
            lens[row, n:n + len(tail)] = tail
    lens = lens.astype(np.int32)
    words = rng.integers(0, 1 << 32, (2, b, s), dtype=np.uint64)
    if not garbage:
        hi_bits = np.clip(lens - 32, 0, 32).astype(np.uint64)
        lo_bits = np.clip(lens, 0, 32).astype(np.uint64)
        words[0] &= (np.uint64(1) << hi_bits) - np.uint64(1)
        words[1] &= (np.uint64(1) << lo_bits) - np.uint64(1)
    his, los = (w.astype(np.uint32).view(np.int32) for w in words)
    if wide:
        return lens, his, los
    return lens, los


def pull_all(parse_launch, desc: str, timeout: float = 60):
    """Play the launch string ``desc`` (ending in ``appsink name=out``)
    through ``parse_launch`` (flutpu's or the port's: each package's
    registry holds its own elements) and pull every buffer."""
    p = parse_launch(desc)
    sink = p.get_by_name("out")
    p.play()
    bufs = []
    try:
        while (buf := sink.try_pull_buffer(timeout=timeout)) is not None:
            bufs.append(buf)
    finally:
        p.stop()
    return bufs


def tie_contract(got: np.ndarray, want: np.ndarray, max_share: float):
    """Equal except ±1 on at most ``max_share`` of the values (rounding
    ties moved by a different fp32 summation order)."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max(initial=0) <= 1, d.max()
    share = float((d > 0).mean()) if d.size else 0.0
    assert share <= max_share, share
    return share


def run_element(harness_cls, buffer_cls, launch: str, doc: str):
    """Push one TTML document through the element ``launch`` in a
    ``harness_cls`` (flutpu's or the port's, with its ``buffer_cls``) and
    return every output buffer as (pts, duration, data). The harness runs
    the chain in the caller's thread, so after the EOS everything is
    there."""
    h = harness_cls(launch)
    h.set_src_caps("application/ttml+xml")
    h.push(buffer_cls(doc.encode(), pts=0))
    h.push_eos()
    out = []
    while (b := h.pull(timeout=30)) is not None:
        out.append((b.pts, b.duration, b.data))
    h.teardown()
    return out


def corpus_docs():
    """(key, text) of every document of tests/ttml_corpus."""
    import os
    root = os.path.join(os.path.dirname(__file__), "ttml_corpus")
    out = []
    for area in sorted(os.listdir(root)):
        d = os.path.join(root, area)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith(".xml"):
                with open(os.path.join(d, name)) as fh:
                    out.append((f"{area}/{name[:-4]}", fh.read()))
    return out


def chunk_pairs(c: int, h: int, w: int, seed: int = 0):
    """(cur, prev) float32 (c, h, w) numpy planes of unlike chunks, one
    per GOP chunk, cycling through: a rolled plane plus noise, a static
    plane (cur == prev), a scene cut (cur unrelated to prev), a flat pair
    (every candidate ties) and a rolled integer-valued plane (ties
    abound)."""
    rng = np.random.default_rng(seed)
    cur = np.empty((c, h, w), np.float32)
    prev = np.empty((c, h, w), np.float32)
    for k in range(c):
        base = rng.uniform(0, 255, (h, w)).astype(np.float32)
        kind = k % 5
        if kind == 0:
            cur[k] = np.roll(base, (3, -5), axis=(0, 1)) \
                + rng.normal(0, 2, (h, w))
        elif kind == 1:
            cur[k] = base
        elif kind == 2:
            cur[k] = rng.uniform(0, 255, (h, w))
        elif kind == 3:
            base[:] = 100.0
            cur[k] = base
        else:
            base = rng.integers(0, 4, (h, w)).astype(np.float32)
            cur[k] = np.roll(base, (1, 2), axis=(0, 1))
        prev[k] = base
    return cur, prev


def code_of(module):
    """A module's code as AST dumps of its statements, less its docstring
    (a port's copy says in its docstring that it is one)."""
    import ast
    import inspect
    body = ast.parse(inspect.getsource(module)).body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant):
        body = body[1:]
    return [ast.dump(n) for n in body]
