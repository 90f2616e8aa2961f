"""The codec's constant tables on a device, uploaded once.

A tensor made from a numpy array on a CUDA device is a copy from pageable
memory, and PyTorch ends such a copy with a synchronization of the
stream: the host waits until every kernel enqueued before it has run.
The codec's constants (the zigzag orders, an MCU layout's index maps,
the DCT matrix, the Huffman tables, the B-frame display order) reach the
device through ``on_device`` instead: the first use of a table on a
device uploads it under a lock, every later use reads the cached tensor
and enqueues nothing, so a warmed dispatch never waits for the card.
A cached tensor is never written: any stream and any thread may read it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, Optional

import numpy as np
import torch

#: tables kept at once; past it the oldest goes (one MCU layout a
#: geometry holds two or three)
MAX_TABLES = 128

_lock = threading.Lock()
_tables: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def on_device(key: Hashable, array: np.ndarray, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``array`` as a ``dtype`` tensor on ``device``, uploaded the first
    time ``key`` is asked for there and read from the cache after.
    ``key`` names the table and everything its values depend on. Each
    upload adds one to ``on_device.uploads``."""
    k = (key, torch.device(device), dtype)
    t = _tables.get(k)
    if t is None:
        with _lock:
            t = _tables.get(k)
            if t is None:
                t = torch.as_tensor(array, dtype=dtype, device=device)
                _tables[k] = t
                if len(_tables) > MAX_TABLES:
                    _tables.popitem(last=False)
                on_device.uploads += 1
    return t


#: uploads since the count was last set to 0
on_device.uploads = 0
