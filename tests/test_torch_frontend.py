"""Front end (kernel K1): flutpu_torch.codec.ops.frontend against the JAX
package on the CPU (the CUDA kernel against its plain version on the
card: tests/test_torch_cuda.py).

Contract: the port's plain version equals the JAX package's XLA CPU arm
(encode_gop_planes_to_coefs); against the Pallas kernel (interpret mode)
and its replica front_end_reference, which fold the subsample into
block-diagonal matrices and sum in another order, coefficients are equal
except ±1 on rounding ties, on at most 1e-3 of them at test size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.jpeg import encode_gop_planes_to_coefs
from flutpu.codec.ops.dct import blockize
from flutpu.codec.ops.frontend_pallas import (front_end_pallas,
                                              front_end_reference)
from flutpu.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                    scale_qtable, zigzag_flatten)
from flutpu_torch.codec.ops import frontend as F
from torch_helpers import rand_planes, tie_contract

torch.set_num_threads(1)

QY = scale_qtable(LUMA_QTABLE, 85)
QC = scale_qtable(CHROMA_QTABLE, 85)


def _port(planes, qy=QY, qc=QC, device="cpu"):
    r, g, b = (torch.from_numpy(p.copy()).to(device) for p in planes)
    out = F.front_end(r, g, b, torch.from_numpy(qy).to(device),
                      torch.from_numpy(qc).to(device))
    return [o.cpu().numpy() for o in out]


def _zz_planes(planes_out):
    return [np.asarray(zigzag_flatten(blockize(p))) for p in planes_out]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel_interpret(seed):
    planes = rand_planes(2, 64, 256, seed)
    want = _zz_planes(front_end_pallas(*(jnp.asarray(p) for p in planes),
                                       jnp.asarray(QY), jnp.asarray(QC),
                                       interpret=True))
    for got, w, name in zip(_port(planes), want, "y cb cr".split()):
        assert got.shape == w.shape and got.dtype == np.int16, name
        tie_contract(got, w, 1e-3)


def test_plain_matches_front_end_reference():
    planes = rand_planes(2, 64, 256, 2)
    want = _zz_planes(front_end_reference(*(jnp.asarray(p) for p in planes),
                                          jnp.asarray(QY), jnp.asarray(QC)))
    for got, w in zip(_port(planes), want):
        tie_contract(got, w, 1e-3)


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 64, 96), (3, 16, 16)])
def test_plain_matches_xla_cpu_arm(shape):
    planes = rand_planes(*shape, seed=3)
    f, h, w = shape
    want = encode_gop_planes_to_coefs(*(jnp.asarray(p) for p in planes),
                                      jnp.asarray(QY), jnp.asarray(QC),
                                      pad_h=h, pad_w=w)
    for got, c in zip(_port(planes), want):
        tie_contract(got, np.asarray(c), 1e-3)


def test_output_layout():
    y, cb, cr = _port(rand_planes(2, 32, 64, 4))
    assert y.shape == (2, 4, 8, 64)
    assert cb.shape == cr.shape == (2, 2, 4, 64)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    planes = rand_planes(1, 16, 32, 5)
    before = F.front_end.launches
    got = _port(planes)
    want = F.front_end_plain(*(torch.from_numpy(p.copy()) for p in planes),
                             torch.from_numpy(QY), torch.from_numpy(QC))
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a, c.numpy())
    assert F.front_end.launches == before


@pytest.mark.parametrize("shape,dtype", [((1, 16, 24), np.uint8),
                                         ((1, 24, 32), np.uint8),
                                         ((1, 16, 32), np.float32)])
def test_rejects_what_the_kernel_does_not_take(shape, dtype):
    planes = [np.zeros(shape, dtype) for _ in range(3)]
    with pytest.raises(ValueError):
        _port(planes)


@pytest.mark.parametrize("value,ok", [(1, True), (255, True), (0, False),
                                      (256, False), (-3, False)])
def test_table_entries_outside_1_255_are_refused(value, ok):
    """The CUDA kernel's quantizer is proven for divisors 1..255 (what
    scale_qtable gives); the wrapper's check of the table holds it to
    them."""
    q = torch.from_numpy(QY.copy())
    q[2, 5] = value
    if ok:
        F._check_table_values(q)
    else:
        with pytest.raises(ValueError, match="1..255"):
            F._check_table_values(q)


def test_table_check_reads_a_table_again_after_a_change_in_place():
    q = torch.from_numpy(QY.copy())
    F._check_table_values(q)
    F._check_table_values(q)          # remembered: no second read
    q[0, 0] = 0
    with pytest.raises(ValueError):
        F._check_table_values(q)
    key = id(q)
    del q                             # and forgotten with the tensor
    assert key not in F._checked_tables


def test_kernel_source_holds_the_dct_matrix_bit_for_bit():
    """csrc/frontend.cu compiles the 8x8 DCT matrix in (FLU_DCT8) so that
    the multiplies take it as immediates: the literals must be
    dct_matrix(8) as float32, value for value."""
    import os
    import re
    from flutpu_torch import _build
    from flutpu_torch.codec.ops.dct import dct_matrix
    path = os.path.join(os.path.dirname(_build.__file__), "csrc",
                        "frontend.cu")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    body = re.search(r"#define FLU_DCT8(.*?)\n\n", text, re.S).group(1)
    values = np.array([float(v) for v in
                       re.findall(r"-?\d+\.\d+(?=f)", body)], np.float32)
    want = np.ascontiguousarray(dct_matrix(8), np.float32)
    assert values.shape == (64,)
    assert values.tobytes() == want.tobytes()
