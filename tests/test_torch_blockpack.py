"""The non-segment layout's device stage against flutpu's on the CPU.

The per-block packs (K7 ``pack_block_bits_fused``, K8a
``pack_block_bits64``, K8b ``pack_block_bits``) take their plain PyTorch
versions here; each must equal flutpu's Pallas kernel in interpret mode
bit for bit, as must the slot tables, the block concat and the combined
scan encode, on random blocks with the edge cases of baseline Huffman
coding: all-zero blocks, DC-only blocks at ±2047, zero runs of 16, 32
and 62 (one, two and three ZRLs), a nonzero coefficient at position 63
(no EOB), the luma and the chroma tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.ops import entropy as JE
from flutpu.codec.ops.entropy_pallas import (pack_block_bits_fused,
                                             pack_block_bits_pallas,
                                             pack_block_bits_pallas64)
from flutpu_torch.codec.ops import entropy as TE
from flutpu_torch.codec.ops import entropy_kernels as K
from torch_helpers import sparse_coefs

torch.set_num_threads(1)

CASES = [(1, "luma"), (1, "chroma"), (7, "mixed"), (260, "mixed")]


def _edge_rows():
    rows = np.zeros((8, 64), np.int32)       # row 0: all zero
    rows[1, 0], rows[2, 0] = 2047, -2047     # DC only, largest category
    rows[3, 17] = 5                          # run 16: one ZRL
    rows[4, 33] = -1                         # run 32: two ZRLs
    rows[5, 63] = 9                          # run 62: three ZRLs, no EOB
    rows[6, 1:64:7] = 300                    # nonzero at 63 after others
    rows[6, 63] = -1023
    rows[7, 0], rows[7, 1] = -1, 1023
    return rows


def _blocks(b, table, seed=0):
    """(zz (b, 64) int32 DC-diffed blocks, comp (b,) int32): the edge rows
    first, random sparse blocks after, on ``table``'s comp flags."""
    rng = np.random.default_rng(seed + b)
    zz = np.zeros((b, 64), np.int32)
    zz[:, 0] = rng.integers(-2047, 2048, b)
    for i in range(b):
        k = rng.integers(0, 30)
        pos = rng.choice(np.arange(1, 64), size=k, replace=False)
        zz[i, pos] = rng.integers(-1023, 1024, k)
    edge = _edge_rows()
    n = min(b, len(edge))
    zz[:n] = edge[rng.permutation(len(edge))[:n]] if b < len(edge) \
        else edge[:n]
    comp = {"luma": np.zeros(b), "chroma": np.ones(b),
            "mixed": rng.random(b) > 0.5}[table].astype(np.int32)
    return zz, comp


def _both(zz, comp):
    return (jnp.asarray(zz), jnp.asarray(comp)), (torch.from_numpy(zz),
                                                  torch.from_numpy(comp))


def _same(got, want):
    """Port (buf int32 bit patterns, nbits) == flutpu's (uint32, int32)."""
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))


@pytest.mark.parametrize("b,table", CASES)
def test_fused_pack_matches_pallas_kernel(b, table):
    j, t = _both(*_blocks(b, table))
    _same(K.pack_block_bits_fused(*t),
          pack_block_bits_fused(*j, interpret=True))


@pytest.mark.parametrize("b,table", CASES)
def test_merged_slot_tables_and_pack_match(b, table):
    j, t = _both(*_blocks(b, table))
    want = JE._slot_tables_merged(*j)
    got = TE._slot_tables_merged(*t)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(w))
    _same(K.pack_block_bits64(*got),
          pack_block_bits_pallas64(*want, interpret=True))


@pytest.mark.parametrize("b,table", CASES)
def test_slot_tables_and_pack_match(b, table):
    j, t = _both(*_blocks(b, table))
    want = JE._slot_tables(*j)
    got = TE._slot_tables(*t)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    _same(K.pack_block_bits(*got), pack_block_bits_pallas(*want,
                                                          interpret=True))


@pytest.mark.parametrize("b,table", CASES)
def test_three_packs_agree(b, table):
    """K7, K8a and K8b compute one function (flutpu's tests hold its
    three kernels to each other the same way)."""
    zz, comp = (torch.from_numpy(a) for a in _blocks(b, table, seed=5))
    want = K.pack_block_bits_fused(zz, comp)
    for got in (K.pack_block_bits64(*TE._slot_tables_merged(zz, comp)),
                K.pack_block_bits(*TE._slot_tables(zz, comp))):
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    # every word is written and bits past nbits are zero
    words = want[0].numpy().view(np.uint32).astype(np.int64)
    for row, n in zip(words, want[1].tolist()):
        assert not row[(n + 31) // 32:].any()
        if n % 32:
            assert row[n // 32] & ((1 << (32 - n % 32)) - 1) == 0


@pytest.mark.parametrize("out_words", [3, 40, 400])
def test_concat_blocks_v3_matches_flutpu(out_words):
    """Two frames of 130 blocks; a window shorter than the stream drops
    the blocks past it (flutpu's ``mode="drop"``)."""
    zz, comp = _blocks(260, "mixed", seed=9)
    buf, nbits = K.pack_block_bits_fused(torch.from_numpy(zz),
                                         torch.from_numpy(comp))
    got, bits = TE._concat_blocks_v3(buf.view(2, 130, 64), nbits.view(2, 130),
                                     out_words)
    for f in range(2):
        want, want_bits = JE._concat_blocks_v3(
            jnp.asarray(buf[f * 130:(f + 1) * 130].numpy().view(np.uint32)),
            jnp.asarray(nbits[f * 130:(f + 1) * 130].numpy()), out_words)
        np.testing.assert_array_equal(got[f].numpy().view(np.uint32),
                                      np.asarray(want))
        assert int(bits[f]) == int(want_bits)


@pytest.mark.parametrize("prefix_words,dense,fused", [
    (24, False, True), (512, False, True), (512, True, True),
    (512, True, False)])
def test_encode_gop_scans_combined_matches_flutpu(prefix_words, dense,
                                                  fused, monkeypatch):
    """The combined array (bits, then the window of the stream) equals
    flutpu's, also where the window is shorter than the stream, and
    through K8a (``FLUTPU_NO_FUSED_PACK=1``)."""
    monkeypatch.setenv("FLUTPU_NO_FUSED_PACK", "0" if fused else "1")
    y, cb, cr = sparse_coefs(f=2, ybh=8, ybw=12, seed=3, dense=dense)
    lay_j = JE.mcu_layout(12, 8, 6, 4, True)
    lay_t = TE.mcu_layout(12, 8, 6, 4, True)
    want = np.asarray(JE.encode_gop_scans_combined(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), layout=lay_j,
        prefix_words=prefix_words, use_pallas=False))
    got = TE.encode_gop_scans_combined(
        *(torch.from_numpy(a) for a in (y, cb, cr)), lay_t, prefix_words)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_pack_variant_follows_the_environment(monkeypatch):
    monkeypatch.delenv("FLUTPU_NO_FUSED_PACK", raising=False)
    assert TE._resolve_pack_variant() is True
    monkeypatch.setenv("FLUTPU_NO_FUSED_PACK", "1")
    assert TE._resolve_pack_variant() is False
    monkeypatch.setenv("FLUTPU_NO_FUSED_PACK", "0")
    assert TE._resolve_pack_variant() is True


def test_wrappers_refuse_other_devices_and_bad_tables():
    """A CPU tensor takes the plain version (no launch counted); any other
    device, and tables of another dtype or shape, raise."""
    zz, comp = (torch.from_numpy(a) for a in _blocks(7, "mixed"))
    lens, his, los = TE._slot_tables_merged(zz, comp)
    before = (K.pack_block_bits_fused.launches, K.pack_block_bits64.launches,
              K.pack_block_bits.launches)
    K.pack_block_bits_fused(zz, comp)
    K.pack_block_bits64(lens, his, los)
    assert (K.pack_block_bits_fused.launches, K.pack_block_bits64.launches,
            K.pack_block_bits.launches) == before
    with pytest.raises(ValueError):
        K.pack_block_bits(lens.to("meta"), his.to("meta"))
    with pytest.raises(ValueError):
        K.pack_block_bits64(lens, his.to(torch.int64), los)
    with pytest.raises(ValueError):
        K.pack_block_bits(lens, his[:, :3])
