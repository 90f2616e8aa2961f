"""The FVC in-loop transform (K9, ``ops/transform_kernels.py``) on the
CPU: its plain versions against an explicit chain of fused multiply-adds
and against flutpu's ``plane_dct`` / ``plane_idct``, the wrappers'
routing, and the in-loop coder's independence of the batch shape.

Contract: ``block_dct_plain`` and ``block_idct_plain`` (PyTorch's CPU
matrix product) equal, bit for bit, every output computed as ``acc =
fma(a_k, b_k, acc)`` over k = 0..7 in ascending order from ``acc = +0``
(csrc/transform.cu computes exactly that on the card); they lie within
1e-4 of flutpu's XLA products on |x| <= 255 (another summation order).
Without JAX (the machine with the card): ``python -m pytest --noconftest
-p no:cacheprovider tests/test_torch_transform.py -k "not flutpus"``."""

import numpy as np
import pytest
import torch

from flutpu_torch.codec import fvc as tf
from flutpu_torch.codec.ops import dct as tdct
from flutpu_torch.codec.ops import transform_kernels as T
from flutpu_torch.codec.ops.quant import LUMA_QTABLE, scale_qtable

torch.set_num_threads(1)

C = tdct.dct_matrix(8)

#: batch shapes of 8x8 blocks, from one block to two chunks of two
#: 544x960 frames
SHAPES = [(1, 8, 8), (3, 8, 8), (2, 5, 7, 8, 8), (68, 120, 8, 8),
          (4, 2, 68, 120, 8, 8)]


def _fmaf(a, b, c):
    """float32 fma(a, b, c) with one rounding: the product is exact in
    float64, the float64 sum's error is recovered (TwoSum), and a sum
    that lands on a float32 midpoint is rounded toward its error."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.astype(np.float32)
    toward = np.nextafter(r, np.where(s > r, np.float32(np.inf),
                                      np.float32(-np.inf)))
    mid = (s != r) & (s == (r.astype(np.float64) + toward) / 2) & (err != 0)
    up = (err > 0) == (toward > r)
    return np.where(mid & up, toward, r).astype(np.float32)


def _chain(a, b):
    """[..., m, 8] @ [..., 8, n] as the k-ascending fma chain from +0."""
    acc = np.zeros(np.broadcast_shapes(a[..., :, :1].shape,
                                       b[..., :1, :].shape), np.float32)
    for k in range(a.shape[-1]):
        acc = _fmaf(a[..., :, k:k + 1], b[..., k:k + 1, :], acc)
    return acc


def _blocks(shape, seed):
    """Seeded blocks of ``shape`` in [-255, 255], some -0 among them (a
    whole block, a column and scattered samples)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-255, 255, shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = -0.0
    flat = x.reshape(-1, 8, 8)
    flat[0] = -0.0
    flat[-1, :, 3] = -0.0
    return x


def _as_4d(blocks):
    """At least (BH, BW, 8, 8): a leading block row where there is none."""
    return blocks if blocks.ndim >= 4 else blocks[None]


def _bits(t):
    return np.asarray(t).view(np.int32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_are_the_fma_chain(shape):
    """PyTorch's CPU product is the k-ascending fma chain from +0, at every
    batch shape: the order K9 computes on the card. This fails the day
    PyTorch's CPU order changes."""
    x = _as_4d(_blocks(shape, 1))
    plane = tdct.unblockize(torch.from_numpy(x))
    want = _chain(_chain(np.broadcast_to(C, x.shape), x),
                  np.broadcast_to(C.T, x.shape))
    got = T.block_dct_plain(plane)
    assert got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))

    d = _as_4d(_blocks(shape, 2))
    want = _chain(_chain(np.broadcast_to(C.T, d.shape), d),
                  np.broadcast_to(C, d.shape))
    got = T.block_idct_plain(torch.from_numpy(d))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(tdct.unblockize(torch.from_numpy(
                                      want))))


def test_fmaf_rounds_once():
    """The emulated fma on sums that a float64 add would round twice: 1 +
    2^-23 + 2^-24 - 2^-70 lies just below a float32 midpoint, which the
    float64 sum lands on (ties to even would then round up); and +0 from
    -0 * 3 + 0."""
    a = np.array([2.0 ** -24 * (1 + 2.0 ** -23)], np.float32)
    b = np.array([1 - 2.0 ** -23], np.float32)
    c = np.array([1 + 2.0 ** -23], np.float32)
    twice = np.float32(a.astype(np.float64) * b + c)
    assert twice == np.float32(1 + 2.0 ** -22)
    assert _fmaf(a, b, c)[0] == np.float32(1 + 2.0 ** -23)
    z = _fmaf(np.array([-0.0], np.float32), np.array([3.0], np.float32),
              np.array([0.0], np.float32))
    assert z[0] == 0 and not np.signbit(z[0])


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_plain_versions_match_flutpus(lead):
    """Against flutpu's plane_dct / plane_idct on the same planes and
    coefficients: max |d| <= 1e-4 on |x| <= 255 (XLA sums in another
    order: one ulp apart in about half the outputs). flutpu is imported
    here, so that the rest of the file runs where JAX is not installed,
    as on the machine with the card."""
    import jax.numpy as jnp
    from flutpu.codec.ops import dct as jdct
    rng = np.random.default_rng(3)
    x = rng.uniform(-255, 255, (*lead, 40, 56)).astype(np.float32)
    got = T.block_dct_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(jdct.plane_dct(jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4
    c = rng.uniform(-255, 255, (*lead, 5, 7, 8, 8)).astype(np.float32)
    got = T.block_idct_plain(torch.from_numpy(c)).numpy()
    want = np.asarray(jdct.plane_idct(jnp.asarray(c)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4


def test_plane_dct_routes_through_the_wrappers():
    """plane_dct / plane_idct are the wrappers: on the CPU the plain
    versions, bit for bit, and no launch counted."""
    x = torch.from_numpy(_blocks((2, 3, 4, 8, 8), 4))
    plane = tdct.unblockize(x)
    before = (T.block_dct.launches, T.block_idct.launches)
    assert torch.equal(tdct.plane_dct(plane), T.block_dct_plain(plane))
    assert torch.equal(tdct.plane_idct(x), T.block_idct_plain(x))
    assert torch.equal(T.block_dct(plane), tdct.dct2(tdct.blockize(plane)))
    assert torch.equal(T.block_idct(x), tdct.unblockize(tdct.idct2(x)))
    assert (T.block_dct.launches, T.block_idct.launches) == before


def test_wrappers_refuse_other_devices_and_shapes():
    meta = torch.empty((16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        T.block_dct(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        T.block_idct(torch.empty((2, 2, 8, 8), device="meta"))
    with pytest.raises(ValueError, match="multiples of 8"):
        T.block_dct(torch.zeros((12, 16)))
    with pytest.raises(ValueError, match="8, 8"):
        T.block_idct(torch.zeros((2, 2, 4, 4)))
    with pytest.raises(ValueError, match="8x8"):
        tdct.plane_dct(torch.zeros((16, 16)), block=16)


def test_non_contiguous_and_integer_inputs():
    """A transposed view and an integer plane give the contiguous float32
    plane's bits."""
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -255, 255, (24, 40)).astype(np.float32))
    assert torch.equal(T.block_dct(x.T), T.block_dct(x.T.contiguous()))
    q = torch.arange(-640, 640, dtype=torch.int32).reshape(2, 10, 8, 8)[
        :, 2:5]
    assert not q.is_contiguous()
    assert torch.equal(T.block_idct(q), T.block_idct(q.to(torch.float32)))


@pytest.mark.parametrize("planar", [False, True], ids=["block", "planar"])
def test_code_plane_batched_equals_each_chunk(planar):
    """The in-loop coder over C = 3 chunks' residual planes equals each
    chunk's own call, bit for bit: coefficients and reconstruction."""
    rng = np.random.default_rng(6)
    resid = torch.from_numpy(rng.normal(0, 40, (3, 48, 64))
                             .astype(np.float32))
    qtab = torch.from_numpy(scale_qtable(LUMA_QTABLE, 85).astype(np.int32))
    coefs, rec = tf._code_plane(resid, qtab, planar)
    for ci in range(3):
        one_coefs, one_rec = tf._code_plane(resid[ci], qtab, planar)
        assert torch.equal(coefs[ci], one_coefs)
        assert torch.equal(_bits_t(rec[ci]), _bits_t(one_rec))


def _bits_t(t):
    return t.contiguous().view(torch.int32)
