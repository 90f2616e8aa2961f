"""The yardstick: the card's published peaks and the operations and bytes
of the search kernels, counted from their shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense, at its 700 W limit: 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3. A search
is counted as the repository's kernel table counts it: per pixel and
candidate a subtraction, an absolute value and an add (3 float32
operations); cur and prev read once, the prediction and the int32
vectors written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
MB = 16


def bound_ms(n_bytes: float, ops: float) -> float:
    """The least time for work of ``n_bytes`` and ``ops`` float32
    operations: the larger of the two over their peaks, in ms."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def _io_bytes(h: int, w: int) -> int:
    return 3 * h * w * 4 + (h // MB) * (w // MB) * 2 * 4


def full_search(h: int, w: int, r: int):
    """(bytes, ops) of one (h, w) plane's full search (K3) at +-r."""
    return _io_bytes(h, w), h * w * (2 * r + 1) ** 2 * 3


def hier_search(h: int, w: int, r: int):
    """(bytes, ops) of one (h, w) plane's hierarchical search (K5) at
    +-r: the +-max(1, r // 2) search of the 2x2-pooled planes, the +-1
    refine at full resolution and the two pools (an add per pixel)."""
    rc = max(1, r // 2)
    coarse = (h // 2) * (w // 2) * (2 * rc + 1) ** 2 * 3
    return _io_bytes(h, w), h * w * 9 * 3 + coarse + 2 * h * w


def search_bound_ms(search: str, h: int, w: int, r: int,
                    planes: int = 1) -> float:
    """Bound of one search launch over ``planes`` (h, w) planes."""
    n_bytes, ops = (hier_search if search == "hier" else full_search)(h, w,
                                                                        r)
    return bound_ms(planes * n_bytes, planes * ops)
