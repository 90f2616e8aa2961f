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
