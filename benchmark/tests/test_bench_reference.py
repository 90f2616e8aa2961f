"""The plain reference: its scan coder and its chunks against the
program's CPU path, its float32 fma, its imports, and its control (the
reference in bfloat16), which the check must refuse."""

import ast
import os

import numpy as np
import pytest
import torch

from benchlib import ref_fvc, ref_scan, source

FORBIDDEN = {"flutpu_torch", "flutpu", "jax", "jaxlib", "flax"}
LIB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchlib")


def _planes(seed, dense):
    rng = np.random.default_rng(seed)

    def plane(bh, bw, p):
        a = rng.laplace(0, 8, (bh, bw, 64)) * (rng.random((bh, bw, 64)) < p)
        a = np.clip(np.round(a), -1023, 1023).astype(np.int16)
        a[..., 0] = rng.integers(-1023, 1024, (bh, bw))
        return a

    return plane(6, 10, dense), plane(3, 5, dense), plane(3, 5, dense / 3)


@pytest.mark.parametrize("seed,dense", [(1, 0.05), (2, 0.3), (3, 1.0),
                                        (4, 0.0)])
def test_scan_equals_the_programs_coder(seed, dense):
    from flutpu_torch.codec.jpeg import _encode_scan_python
    y, cb, cr = _planes(seed, dense)
    if dense == 1.0:
        y[0, 0, 1:] = 0          # a block of zeros
        y[0, 1, 1:17] = 0        # a run over 16: one ZRL
        y[0, 1, 17] = 1023
    assert ref_scan.encode_scan(y, cb, cr) == \
        _encode_scan_python(y, cb, cr, True)


def _pan(frames, h, w, step, seed):
    """A pan with two moving objects of 16 x 16 and grain."""
    return source.pan_pool(1, frames, h, w, step, 2, seed, "cpu", (16, 16),
                           [(1, 3), (2, 1)], 1.0)[0]


@pytest.mark.parametrize("hier,h,w,r", [(False, 40, 72, 6),
                                        (False, 64, 96, 12),
                                        (True, 40, 72, 6),
                                        (True, 64, 96, 20)])
def test_chunk_equals_the_programs(hier, h, w, r):
    from flutpu_torch.codec.fvc import FvcEncoder
    frames = _pan(5, h, w, (2, 5), 3)
    enc = FvcEncoder(85, motion=True, search_range=r, hier=hier,
                     device="cpu")
    assert ref_fvc.encode_chunk(frames, 85, r, hier) == \
        enc.encode_chunk(frames)


@pytest.mark.parametrize("hier", [False, True])
def test_control_is_refused(hier):
    """The reference in bfloat16 in the program's place: its chunks differ
    from the float32 reference's, so the check's count is nonzero."""
    for seed in (1, 2, 3):
        frames = _pan(4, 40, 72, (2, 5), seed)
        assert ref_fvc.encode_chunk(frames, 85, 6, hier, torch.bfloat16) \
            != ref_fvc.encode_chunk(frames, 85, 6, hier)


def test_fmaf_rounds_once():
    """A sum that a float64 add would round twice (1 + 2^-23 + 2^-24 -
    2^-70 lies below a float32 midpoint), and +0 from -0 * 3 + 0."""
    a = torch.tensor([2.0 ** -24 * (1 + 2.0 ** -23)], dtype=torch.float32)
    b = torch.tensor([1 - 2.0 ** -23], dtype=torch.float32)
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    assert (a.double() * b.double() + c.double()).float().item() == \
        np.float32(1 + 2.0 ** -22)
    assert ref_fvc.fmaf(a, b, c).item() == np.float32(1 + 2.0 ** -23)
    z = ref_fvc.fmaf(torch.tensor([-0.0]), torch.tensor([3.0]),
                     torch.tensor([0.0]))
    assert z.item() == 0 and not torch.signbit(z).item()


def test_transform_is_the_fma_chain():
    """The reference's 8x8 DCT equals PyTorch's CPU product bit for bit
    (the order the program's kernels follow)."""
    x = torch.rand((3, 5, 8, 8), generator=torch.Generator().manual_seed(
        0)) * 510 - 255
    c = torch.as_tensor(ref_fvc.dct_matrix())
    got = ref_fvc.chain(ref_fvc.chain(c, x, torch.float32), c.T,
                        torch.float32)
    assert torch.equal(got.view(torch.int32), (c @ x @ c.T).view(torch.int32))


@pytest.mark.parametrize("name", ["ref_fvc.py", "ref_scan.py"])
def test_reference_imports_nothing_of_the_program(name):
    """Top-level names, compared whole, and within the benchmark only the
    reference's own modules."""
    tree = ast.parse(open(os.path.join(LIB, name)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert all(a.name.startswith("ref_") for a in node.names)
                continue
            mods = [node.module]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in FORBIDDEN, m
            assert m.split(".")[0] in {"numpy", "torch", "struct", "zlib",
                                       "__future__"}, m
