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


def split_at_ties(frames, got, want, qy, qc, subpel=False, bframes=0,
                  qy_b=None, qc_b=None):
    """Two outputs of one chunk program (numpy, display order: P-only
    ``(ry, rcb, rcr, mvs, itypes)``; with ``bframes`` ``(ry, rcb, rcr,
    fwd, bwd, modes, ftypes)``) for (F, H, W, 3) uint8 ``frames`` at their
    coded size, which may differ where a float tie split them. At the
    first frame in coding order (anchors, then B frames) whose outputs
    differ, everything before is the same in both, so its prediction is
    rebuilt in float64 from ``want``'s coefficients. There the modes and
    frame types must be equal; half-pel vectors may differ where the two
    candidates' float64 costs on that reference lie within one fp32
    rounding of a sample per pixel (256 * 2^-16, ``test_torch_fvc``'s
    half-pel near-tie), integer vectors not at all; with the same
    vectors the coefficients may differ only by 1, where the float64
    quotient lies within 2e-3 of a rounding boundary (each output's
    coefficients being its quotients rounded and clamped). Returns the
    number of split vectors or coefficients, 0 where the outputs are
    equal."""
    from flutpu_torch.codec.fvc import (_CLAMP, _bframe_structure,
                                        _repeat_blocks, _select_mode)
    from flutpu_torch.codec.ops.colorspace import planes_to_i420
    from flutpu_torch.codec.ops.dct import blockize, dct_matrix, unblockize
    from flutpu_torch.codec.ops.motion import (motion_compensate,
                                               motion_compensate_subpel)
    from flutpu_torch.codec.ops.quant import zigzag_unflatten
    f = frames.shape[0]
    types = np.asarray(want[-1])
    np.testing.assert_array_equal(got[-1], types)
    anchors, b_idx = list(range(f)), []
    if bframes:
        anchors, b_idx = _bframe_structure(f, bframes)[:2]

    def same(i):
        return all(np.array_equal(g[i], w[i]) for g, w in zip(got, want))

    diff = [i for i in anchors + b_idx if not same(i)]
    if not diff:
        return 0
    fd = diff[0]
    c = torch.as_tensor(dct_matrix(8)).double()

    def block64(zz):
        return zigzag_unflatten(torch.as_tensor(zz.astype(np.int64))).double()

    def tables(y, ch):
        return [torch.as_tensor(np.asarray(t)).double() for t in (y, ch, ch)]

    mc = motion_compensate_subpel if subpel else motion_compensate

    def predict(ref, mv):
        mv = torch.as_tensor(np.asarray(mv).astype(np.int64))
        return [mc(ref[0], mv)] + [mc(p, mv, mb=8) for p in ref[1:]]

    def intra(i):
        return i == 0 or types[i] == 1

    cur = [p.double() for p in planes_to_i420(*(
        torch.from_numpy(np.ascontiguousarray(frames[..., k]))
        for k in range(3)))]
    qs = tables(qy, qc)
    recs, prev = {}, None
    for i in anchors:
        if i == fd:
            break
        pred = [128.0] * 3 if intra(i) else predict(recs[prev], want[3][i])
        recs[i] = [(p + unblockize(c.T @ (block64(want[k][i]) * q) @ c))
                   .clamp(0.0, 255.0)
                   for k, (p, q) in enumerate(zip(pred, qs))]
        prev = i
    for k in range(4, len(want) - 1):
        np.testing.assert_array_equal(got[k][fd], want[k][fd])
    split = np.argwhere((got[3][fd] != want[3][fd]).any(-1))
    if len(split):
        assert subpel and not intra(fd), split
        for by, bx in split:
            sl = (slice(16 * by, 16 * by + 16), slice(16 * bx, 16 * bx + 16))
            sads = []
            for mv in (got[3][fd], want[3][fd]):
                one = np.zeros_like(mv)
                one[by, bx] = mv[by, bx]
                pred = mc(recs[prev][0], torch.as_tensor(one.astype(np.int64)))
                sads.append(float((cur[0][fd][sl] - pred[sl]).abs().sum()))
            assert abs(sads[0] - sads[1]) <= 256 * 2.0 ** -16, (by, bx, sads)
        return len(split)
    if fd in b_idx:
        p0 = max(a for a in anchors if a < fd)
        p1 = min(a for a in anchors if a > fd)
        pf, pb = predict(recs[p0], want[3][fd]), predict(recs[p1],
                                                         want[4][fd])
        mode = torch.as_tensor(want[5][fd].astype(np.int64))
        pred = [_select_mode(_repeat_blocks(mode, m), (x + y) * 0.5, x, y)
                for m, x, y in zip((16, 8, 8), pf, pb)]
        qs = tables(qy_b, qc_b)
    elif intra(fd):
        pred = [128.0] * 3
    else:
        pred = predict(recs[prev], want[3][fd])
    n = 0
    for k, (x, p, q) in enumerate(zip(cur, pred, qs)):
        v = (c @ blockize(x[fd] - p) @ c.T) / q
        a, b = block64(got[k][fd]), block64(want[k][fd])
        for o in (a, b):
            assert float((v.clamp(-_CLAMP, _CLAMP) - o).abs().max()) \
                <= 0.5 + 2e-3
        d = (a - b).abs()
        if not bool(d.any()):
            continue
        assert float(d.max()) == 1.0
        off = (v - (torch.minimum(a, b) + 0.5)).abs()[d > 0]
        assert float(off.max()) <= 2e-3, float(off.max())
        n += int((d > 0).sum())
    assert n > 0
    return n


def planar_drift(frames, qy, qc, stripes: int = 1, planar: bool = True,
                 **kw):
    """The planar motion loop over (F, H, W, 3) uint8 ``frames`` (a tensor
    on the device to run on) cut into ``stripes`` row stripes of H /
    stripes rows, each coded with stripe-height block-diagonal products,
    against the decoder's reconstruction of its output over the whole
    frame (``fvc_mc_decode_chunk``, full-height products). With
    ``planar=False`` the loop and the decoder run the per-block transform
    instead. Returns the number of in-loop samples, over every frame and
    plane, that the decoder does not rebuild bit for bit."""
    from flutpu_torch.codec import fvc as tf
    h, w = frames.shape[1:3]
    hs = h // stripes
    parts = [frames[:, s * hs:(s + 1) * hs] for s in range(stripes)]
    y, cb, cr, _ = tf._stripes_in(parts if stripes > 1 else frames, hs, w,
                                  stripes > 1)
    out, itypes, recs = tf._anchor_loop(y, cb, cr, qy, qc,
                                        tf._search_fn(False), 7,
                                        planar=planar, **kw)
    ry, rcb, rcr, mvs = (tf._gather_rows(p, 2)[0] for p in zip(*out))
    dec = tf.fvc_mc_decode_chunk(ry, rcb, rcr, mvs, itypes[0], qy, qc,
                                 planar=planar, **kw)
    return sum(int((torch.cat(want, dim=-2)[0] != got[i]).sum())
               for i, rec in enumerate(recs) for want, got in zip(rec, dec))


def capped_prefix(monkeypatch, coder, cap: int) -> list:
    """Patch ``coder``'s (a ``JpegEncoder``) prefix cap to ``cap`` words a
    frame → the list that collects the window each dispatch starts at
    (an overflow's redispatch is not a start)."""
    starts = []
    run = coder._run_sized

    def spy(*args):
        out = run(*args)
        starts.append(out[1])
        return out

    monkeypatch.setattr(coder, "_prefix_cap", lambda layout: cap)
    monkeypatch.setattr(coder, "_run_sized", spy)
    return starts


def profiled_spans(fn):
    """``fn()`` under a CPU profiler → (its result, [(program span name
    less the prefix, start ns, end ns)] by start, an enclosing span
    first)."""
    from torch.profiler import ProfilerActivity, profile
    from flutpu_torch.core import log
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name()[len(log.SPAN_PREFIX):], e.start_ns(),
                     e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(log.SPAN_PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def pan_clip(c: int, f: int, h: int, w: int, step=(2, 6), seed: int = 5):
    """(C, F, H, W, 3) uint8: a random texture panned ``step`` px a
    frame, each chunk from its own start."""
    rng = np.random.default_rng(seed)
    sy, sx = step
    tex = rng.integers(0, 256, (h + sy * (c * f + 1), w + sx * (c * f + 1),
                                3), np.uint8)
    out = np.empty((c, f, h, w, 3), np.uint8)
    for ci in range(c):
        for i in range(f):
            k = ci * f + i
            out[ci, i] = tex[k * sy:k * sy + h, k * sx:k * sx + w]
    return out


def dispatch_entries(device, c: int, f: int, h: int, w: int,
                     hier: bool = False, search_range: int = 7):
    """The one-device dispatch entries on one ``pan_clip`` of C chunks:
    name → (dispatch(enc) → handle, finalize(enc, handle) → list of
    bytes, an encoder, a factory of fresh ones). ``chunk``: the FVC
    encoder's ``encode_chunk_dispatch`` of chunk 0; ``chunks``: its
    ``encode_chunks_dispatch`` of all C; ``jpeg``: ``JpegEncoder``'s
    ``encode_gop_dispatch`` of chunk 0's frames."""
    from flutpu_torch.codec.fvc import FvcEncoder
    from flutpu_torch.codec.jpeg import JpegEncoder

    def fvc():
        return FvcEncoder(85, motion=True, search_range=search_range,
                          hier=hier, device=device)

    def jpeg():
        return JpegEncoder(85, device=device)

    frames = torch.from_numpy(pan_clip(c, f, h, w)).to(device)
    return {
        "chunk": (lambda enc: enc.encode_chunk_dispatch(frames[0]),
                  lambda enc, hd: [enc.encode_chunk_finalize(hd)],
                  fvc(), fvc),
        "chunks": (lambda enc: enc.encode_chunks_dispatch(frames),
                   lambda enc, hd: enc.encode_chunks_finalize(hd),
                   fvc(), fvc),
        "jpeg": (lambda enc: enc.encode_gop_dispatch(frames[0], h, w),
                 lambda enc, hd: enc.encode_gop_finalize(hd),
                 jpeg(), jpeg),
    }
