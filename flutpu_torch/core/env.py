"""Environment flag parsing shared by the A/B and formulation overrides.

One convention everywhere: unset → the caller's default; ``0`` / ``false``
/ ``no`` / empty → False; anything else → True. Plain string truthiness
would let ``FLUTPU_SEARCH_DYGRID=0`` silently ENABLE the dy-grid arm,
and a hardware A/B would compare the same arm against itself.
"""

import os
from typing import Optional


def env_flag(name: str, default: Optional[bool] = None) -> Optional[bool]:
    """Tri-state environment flag: None when unset (caller decides),
    else the parsed boolean."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "no")
