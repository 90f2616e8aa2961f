"""A warmed dispatch uploads nothing to its device.

The codec's constant tables (zigzag orders, MCU layouts) reach a device
once, through ``ops.constants.on_device``; a dispatch after the first at
a geometry adds nothing to its upload counter. On the card the same
dispatches run under ``torch.cuda.set_sync_debug_mode("error")``
(``tests/test_torch_cuda.py:test_warmed_dispatch_never_syncs``).
"""

import numpy as np
import pytest
import torch

from flutpu_torch.codec.ops.constants import on_device
from flutpu_torch.codec.ops.entropy import layout_table, mcu_layout
from flutpu_torch.codec.ops.quant import (inverse_zigzag_index,
                                          inverse_zigzag_order, zigzag_index,
                                          zigzag_order)
from torch_helpers import dispatch_entries

torch.set_num_threads(1)


@pytest.mark.parametrize("entry", ["chunk", "chunks", "jpeg"])
def test_warmed_dispatch_uploads_nothing(entry):
    """The second dispatch at a geometry (C = 2 chunks of 4 frames at
    48x64) adds nothing to the upload counter, and its bytes are the
    first's and a fresh encoder's."""
    dispatch, finalize, enc, fresh = dispatch_entries("cpu", 2, 4, 48,
                                                      64)[entry]
    first = finalize(enc, dispatch(enc))
    before = on_device.uploads
    handle = dispatch(enc)
    assert on_device.uploads == before
    assert finalize(enc, handle) == first
    other = fresh()
    assert finalize(other, dispatch(other)) == first


@pytest.mark.parametrize("table", [
    ("zigzag", 8), ("inverse_zigzag", 8), ("zigzag", 4),
    ("mcu", (8, 6, 4, 3, True)), ("mcu", (6, 3, 3, 2, True)),
    ("mcu", (4, 2, 4, 2, False))])
def test_cached_tables_equal_their_arrays(table):
    """Each cached table holds its array's values, and a second lookup
    returns the same tensor without an upload."""
    kind, arg = table
    dev = torch.device("cpu")
    if kind == "mcu":
        layout = mcu_layout(*arg)
        pairs = [(lambda name=name: layout_table(layout, name, dev),
                  getattr(layout, name))
                 for name in ("block_sel", "prev_same_comp",
                              "comp_is_chroma")]
    elif kind == "zigzag":
        pairs = [(lambda: zigzag_index(arg, dev), zigzag_order(arg))]
    else:
        pairs = [(lambda: inverse_zigzag_index(arg, dev),
                  inverse_zigzag_order(arg))]
    for lookup, want in pairs:
        got = lookup()
        assert got.device == dev
        np.testing.assert_array_equal(got.numpy(), want)
        before = on_device.uploads
        assert lookup() is got
        assert on_device.uploads == before


def test_tables_upload_once_under_threads(monkeypatch):
    """Sixteen threads ask for the same fresh tables at once (the hype
    bin's streaming threads launch first together), each upload slowed
    to 5 ms as a copy to a busy card would be: each table is uploaded
    once, and every thread gets the one cached tensor."""
    import sys
    import threading
    import time
    as_tensor = torch.as_tensor

    def slow_as_tensor(*args, **kwargs):
        time.sleep(0.005)
        return as_tensor(*args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", slow_as_tensor)
    keys = [("threads test", i) for i in range(4)]
    arrays = [np.arange(64, dtype=np.int32) * (i + 1) for i in range(4)]
    got = [[None] * len(keys) for _ in range(16)]
    start = threading.Barrier(16)

    def ask(t):
        start.wait(timeout=30)
        for i, (key, arr) in enumerate(zip(keys, arrays)):
            got[t][i] = on_device(key, arr, torch.device("cpu"), torch.long)

    before = on_device.uploads
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert on_device.uploads == before + len(keys)
    for i, arr in enumerate(arrays):
        assert all(row[i] is got[0][i] for row in got)
        np.testing.assert_array_equal(got[0][i].numpy(), arr)
