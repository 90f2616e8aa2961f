"""Segment Huffman pack (kernel K2) and the segment-layout entropy stage:
flutpu_torch against the JAX package on the CPU (the CUDA kernel against
its plain version on the card: tests/test_torch_cuda.py).

Contract everywhere: bit identity. The port's segbuf/segbits equal the
Pallas kernel's (interpret mode) for the same blocks, including padding
blocks and segments over capacity (whose bit count stays exact), and the
combined per-frame array equals the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.ops import entropy as JE
from flutpu.codec.ops.entropy_pallas import pack_segments_fused
from flutpu_torch.codec.ops import entropy as TE
from flutpu_torch.codec.ops import entropy_kernels as K
from torch_helpers import pack_edge_blocks, sparse_coefs

torch.set_num_threads(1)


def _words(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _edge_blocks() -> np.ndarray:
    """Blocks that reach every rule: a lone coefficient at 63 (three ZRLs,
    no EOB), size-11 DC and size-10 AC, runs of exactly 16 and 32, a
    zero block, a full block."""
    z = np.zeros((6, 64), np.int32)
    z[0, 63] = -3
    z[1, 0], z[1, 1], z[1, 2] = 2047, -1023, 512
    z[2, 0], z[2, 17], z[2, 50] = -5, 1, -1
    z[3, 33] = 7
    z[5] = np.arange(1, 65) * np.where(np.arange(64) % 2, -1, 1)
    return z


def _blocks(n, seed, dense=False):
    """n DC-diffed blocks (edge blocks first) and a 4:2:0 comp pattern."""
    rng = np.random.default_rng(seed)
    z = rng.integers(-60, 60, (n, 64)).astype(np.int32)
    z = np.where(rng.random((n, 64)) < (0.5 if dense else 0.1), z, 0)
    z[:, 0] = rng.integers(-300, 300, n)
    e = _edge_blocks()
    z[:len(e)] = e
    comp = np.tile(np.array([0, 0, 0, 0, 1, 1], np.int32), n // 6 + 1)[:n]
    return z.astype(np.int32), comp


def _pallas(z, comp, seg_words):
    buf, bits = pack_segments_fused(jnp.asarray(z), jnp.asarray(comp),
                                    seg_g=16, seg_words=seg_words,
                                    interpret=True)
    return np.asarray(buf), np.asarray(bits)


@pytest.mark.parametrize("case", ["plain", "padding", "overflow"])
def test_pack_matches_pallas_kernel(case):
    z, comp = _blocks(64, seed=1, dense=case == "overflow")
    seg_words = 4 if case == "overflow" else 64
    if case == "padding":   # the encoder pads frames with zero blocks
        z[40:], comp[40:] = 0, -1
    want_buf, want_bits = _pallas(z, comp, seg_words)
    buf, bits = K.pack_segments(torch.from_numpy(z), torch.from_numpy(comp),
                                seg_g=16, seg_words=seg_words)
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    np.testing.assert_array_equal(_words(buf), want_buf)
    if case == "overflow":
        assert (want_bits > seg_words * 32).any()
    if case == "padding":
        # segment 2 ends in padding blocks, segment 3 is all padding
        assert int(bits[2]) > 0 and int(bits[3]) == 0


@pytest.mark.parametrize("seg_g,seg_words", [
    (1, 64), (2, 4), (16, 1), (16, 4), (16, 64), (16, 832), (16, 1000),
    (17, 64)])
def test_pack_edge_cases_match_pallas_kernel(seg_g, seg_words):
    """The yardstick of the card tests (``pack_segments_plain`` on
    ``pack_edge_blocks``, the generator tests/test_torch_cuda.py holds the
    kernel to) equals the Pallas kernel bit for bit at the segment sizes
    and capacities the card tests use: one word, segments over capacity,
    the encoder's largest buffer (832) and one past all a segment can
    fill (1000)."""
    z, comp = pack_edge_blocks(max(2, 320 // seg_g), seg_g,
                               seed=seg_g * 7 + seg_words)
    want_buf, want_bits = pack_segments_fused(
        jnp.asarray(z), jnp.asarray(comp), seg_g=seg_g, seg_words=seg_words,
        interpret=True)
    buf, bits = K.pack_segments(torch.from_numpy(z), torch.from_numpy(comp),
                                seg_g=seg_g, seg_words=seg_words)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(_words(buf), np.asarray(want_buf))
    assert int(bits[-1]) == 0                    # a whole padding segment


def test_staging_row_limit():
    """K2's kernel stages a segment in a shared-memory row: the buffer,
    or all ``seg_g`` blocks can fill at ``JpegEncoder.BLOCK_BITS_BOUND``
    bits each; a warp holds the rows of the segments its 32 lanes code
    at once (a lane per block) and a tile of 32 blocks. The encoder's
    largest buffer fits; a warp's share past a CUDA block's 227 KB is
    refused before any launch."""
    from flutpu_torch.codec.jpeg import JpegEncoder
    assert K.BLOCK_BITS_BOUND == JpegEncoder.BLOCK_BITS_BOUND
    assert K.staging_words(16, 64) == 64
    assert K.staging_words(16, 832) == 832
    assert K.staging_words(16, 1000) == 16 * 1664 // 32 + 1
    assert K.warp_words(16, 64) == 2 * 68 + 32 * 68      # 64 words + 4
    assert K.warp_words(1, 64) == 32 * 60 + 32 * 68      # 53 words, padded
    assert K.warp_words(17, 64) == 64 + 32 * 68
    K._check_staging(16, 832)
    K._check_staging(1065, 10 ** 6)
    with pytest.raises(ValueError):
        K._check_staging(1066, 10 ** 6)


def test_padding_segment_emits_nothing():
    z = np.zeros((32, 64), np.int32)
    z[:16, 0] = 9
    comp = np.r_[np.zeros(16, np.int32), np.full(16, -1, np.int32)]
    buf, bits = K.pack_segments_plain(torch.from_numpy(z),
                                      torch.from_numpy(comp))
    assert int(bits[1]) == 0 and not _words(buf)[1].any()
    assert int(bits[0]) > 0


def test_pack_rejects_bad_arguments():
    z = torch.zeros((20, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.pack_segments(z, torch.zeros(20, dtype=torch.int32))  # B % 16
    with pytest.raises(ValueError):
        K.pack_segments(z[:16].to(torch.int64),
                        torch.zeros(16, dtype=torch.int32))


@pytest.mark.parametrize("geom", [(12, 8, 6, 4, True), (6, 4, 6, 4, False)])
def test_mcu_blocks_match(geom):
    ybw, ybh, cbw, cbh, sub = geom
    y, cb, cr = sparse_coefs(2, ybh, ybw, seed=2)
    if not sub:
        cb, cr = (sparse_coefs(2, ybh * 2, ybw * 2, seed=s)[1]
                  for s in (3, 4))
    want_m, want_c = JE._mcu_blocks(jnp.asarray(y), jnp.asarray(cb),
                                    jnp.asarray(cr), JE.mcu_layout(*geom))
    got_m, got_c = TE._mcu_blocks(torch.from_numpy(y), torch.from_numpy(cb),
                                  torch.from_numpy(cr), TE.mcu_layout(*geom))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("out_words", [5, 40, 200])
def test_concat_segments_aligned_matches(out_words):
    rng = np.random.default_rng(5)
    f, s, c = 2, 12, 6
    segbuf = rng.integers(0, 2 ** 32, (f, s, c), dtype=np.uint64) \
        .astype(np.uint32)
    segbits = rng.integers(0, c * 32 + 1, (f, s)).astype(np.int32)
    segbits[:, [3, 11]] = 0          # padding segments
    segbits[1, 5] = c * 32 + 40      # over capacity
    want = jax.vmap(lambda b, n: JE._concat_segments_aligned(b, n, out_words))(
        jnp.asarray(segbuf), jnp.asarray(segbits))
    got = TE._concat_segments_aligned(
        torch.from_numpy(segbuf.view(np.int32)), torch.from_numpy(segbits),
        out_words)
    np.testing.assert_array_equal(_words(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_encode_gop_scans_segmented_matches():
    y, cb, cr = sparse_coefs(2, 8, 12, seed=6)
    geom = (12, 8, 6, 4, True)
    want = np.asarray(JE.encode_gop_scans_segmented(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
        layout=JE.mcu_layout(*geom), prefix_words=1024, seg_g=16,
        seg_words=32, interpret=True))
    got = TE.encode_gop_scans_segmented(
        torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr),
        layout=TE.mcu_layout(*geom), prefix_words=1024, seg_g=16,
        seg_words=32)
    np.testing.assert_array_equal(_words(got), want)
    # the host half turns it into the same scan as the JAX host half
    n = (TE.mcu_layout(*geom).n_blocks + 15) // 16
    for i in range(2):
        seg, words = want[i, 1:1 + n], want[i, 1 + n:]
        scan = TE.compact_segments_finalize(seg, words)
        assert scan == JE.compact_segments_finalize(seg, words)
        stream, total = TE.compact_aligned_segments(seg, words)
        want_stream, want_total = JE.compact_aligned_segments(seg, words)
        np.testing.assert_array_equal(stream, want_stream)
        assert total == want_total
        assert TE.stuff_and_finalize(stream, total) == scan


def test_stuff_and_finalize_matches():
    words = np.array([0xFF00FFFF, 0x12FF3400, 0xFFFFFFFF], np.uint32)
    for bits in (0, 5, 32, 61, 96):
        assert (TE.stuff_and_finalize(words, bits)
                == JE.stuff_and_finalize(words, bits))
