"""FVC rate control and batched chunks from the on-device source in
flutpu_torch, against flutpu on the CPU.

Contract: ``cudafvcenc bitrate=`` with ``device=cpu`` runs flutpu's
per-chunk quality controller (``_RC_MIN_Q``/``_RC_MAX_Q``, the chunk's
byte budget from the buffers' durations, the log-proportional update and
the one re-encode of a chunk over 1.3 times its budget), so its chunks
equal ``fvcenc bitrate=``'s chunk for chunk, qualities included;
``encode_chunk_batch_dispatch_src`` / ``encode_chunk_batch_finalize``
give the chunks of ``batch`` separate ``encode_chunk_dispatch_src`` calls
(chunk b from frames ``start + b * n``), byte for byte, in one dispatch
and one copy back."""

import numpy as np
import pytest
import torch

import flutpu.core
import flutpu_torch.core
from flutpu.codec import fvc as jf
from flutpu.core.elements import make_test_frame
from flutpu_torch.codec import fvc as tf
from flutpu_torch.codec.fvc import FvcEncoder
from flutpu_torch.codec.ops.testsrc import gradient_ball_planes

torch.set_num_threads(1)


def _clip(n, w, h, noise=0.0):
    rng = np.random.default_rng(1)
    frames = np.stack([make_test_frame("ball", w, h, i) for i in range(n)])
    if noise:
        frames = np.clip(frames + rng.normal(0, noise, frames.shape), 0,
                         255).astype(np.uint8)
    return frames


def _encode(core, desc, frames):
    """Frames at 30 frames/s (33 ms buffers) through ``desc`` in a
    Harness → the chunks."""
    h = core.Harness(desc)
    h.set_src_caps(f"video/x-raw, format=RGB, width={frames.shape[2]}, "
                   f"height={frames.shape[1]}, framerate=30/1")
    for i, f in enumerate(frames):
        h.push(core.Buffer(f, pts=i * 33 * core.MSECOND,
                           duration=33 * core.MSECOND, offset=i))
    h.push_eos()
    out = []
    while (b := h.pull(timeout=60)) is not None:
        out.append(bytes(b.data))
    h.teardown()
    return out


@pytest.mark.parametrize("opts,noise", [
    pytest.param("bitrate=150000", 0.0, id="v1"),
    pytest.param("bitrate=100000 motion=true", 5.0, id="motion-retry")])
def test_bitrate_chunks_equal_fvcenc(opts, noise):
    """Chunk for chunk equal to flutpu's controller: v1 on the ball clip
    steps the quality down from 85 under a tight budget; motion on noisy
    frames overshoots 1.3 times the first chunk's budget and re-encodes
    it at the corrected quality (67, not 85)."""
    frames = _clip(16, 128, 96, noise)
    want = _encode(flutpu.core, f"fvcenc gop-size=4 {opts}", frames)
    got = _encode(flutpu_torch.core,
                  f"cudafvcenc device=cpu gop-size=4 {opts}", frames)
    assert got == want and len(got) == 4
    qualities = [c[10] for c in got]
    assert len(set(qualities)) > 1
    if noise:
        assert qualities[0] < 85


def test_controller_copies_flutpus():
    """The element's controller is flutpu's: the same limits, the same
    budget from durations, frame rate or 30 frames/s, and a cache of one
    encoder per quality that a property change clears."""
    t = flutpu_torch.core.make("cudafvcenc", device="cpu", bitrate=6000000)
    j = flutpu.core.make("fvcenc", bitrate=6000000)
    assert (t._RC_MIN_Q, t._RC_MAX_Q) == (j._RC_MIN_Q, j._RC_MAX_Q) == \
        (10, 97)
    for dur in (0, 33 * flutpu.core.MSECOND):
        bt = [flutpu_torch.core.Buffer(None, duration=dur)] * 8
        bj = [flutpu.core.Buffer(None, duration=dur)] * 8
        assert t._chunk_target_bytes(bt) == j._chunk_target_bytes(bj)
    # 8 frames at the default 30 frames/s: int(8e9 / 30) ns rounds the
    # 200,000-byte budget down by one, in both packages
    assert t._chunk_target_bytes([flutpu_torch.core.Buffer(None)] * 8) == \
        j._chunk_target_bytes([flutpu.core.Buffer(None)] * 8) == 199999
    assert t._enc(40).quality == 40 and t._enc().quality == 85
    assert set(t._encoders) == {40, 85}
    t.set_property("motion", True)
    assert t._encoders == {} and t._enc().motion


def _src(ph, pw, n, start):
    return gradient_ball_planes(ph, pw, n, start, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"motion": True},
                                {"motion": True, "hier": True,
                                 "bframes": 1}],
                         ids=["v1", "motion", "hier-b"])
def test_batch_src_equals_single_dispatches(kw):
    """Three chunks of 4 frames in one dispatch: each equals its own
    ``encode_chunk_dispatch_src`` (frames 8 + 4b), and flutpu's encode of
    the same frames; the header carries the frame height (88 rows, the
    source renders 96)."""
    te = FvcEncoder(85, device="cpu", **kw)
    je = jf.FvcEncoder(85, **kw)
    handle = te.encode_chunk_batch_dispatch_src(_src, 8, 4, 88, 160,
                                                batch=3)
    got = te.encode_chunk_batch_finalize(handle)
    assert len(got) == 3
    for b, chunk in enumerate(got):
        single = te.encode_chunk_finalize(
            te.encode_chunk_dispatch_src(_src, 8 + 4 * b, 4, 88, 160))
        assert chunk == single
    full = te.encode_chunk_batch_finalize(
        te.encode_chunk_batch_dispatch_src(_src, 8, 4, 96, 160, batch=3))
    for b, chunk in enumerate(full):
        frames = np.stack([p.numpy() for p in _src(96, 160, 4, 8 + 4 * b)],
                          axis=-1)
        assert chunk == je.encode_chunk(frames)


def test_batch_src_is_one_copy_back():
    """The batch comes back in one array of batch x n rows."""
    te = FvcEncoder(85, motion=True, device="cpu")
    handle = te.encode_chunk_batch_dispatch_src(_src, 0, 2, 32, 48, batch=4)
    assert isinstance(handle, tf._ChunkHandle) and handle.f == 2
    arr, _ = te._scan_coder._fetch(handle)
    assert arr.shape[0] == 8
    assert len(te.encode_chunk_batch_finalize(handle)) == 4
