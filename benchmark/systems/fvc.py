"""The adapter of the port's FVC encoder (``flutpu_torch.codec.fvc``):
the configuration keys it reads, the codec settings it codes, the
encoder, its entries per traffic ``entry`` and the plain reference
(``benchlib/ref_fvc.py``) of one chunk.

An adapter (``systems/<adapter>.py``, named by a configuration's
``"adapter"``) provides ``KEYS``, ``MESH_ENTRIES``, ``check(config,
traffic, batch)``, ``make(config, device)``, ``entries(program, entry)``
and ``reference(config, frames, dtype=None)``: see each below."""

from __future__ import annotations

from benchlib import ref_fvc

#: the configuration keys this adapter reads, beside the harness's own
KEYS = {"chroma", "codec", "version", "quality", "motion", "search",
        "search_range", "subpel", "bframes", "engine", "segmented"}
#: the one value of each codec key that the program's call and the
#: reference code
CONFIG_FIXED = {"codec": "fvc", "version": 2, "chroma": "4:2:0",
                "motion": True, "subpel": False, "bframes": 0}
#: the program's entries per traffic ``entry``: (dispatch, finalize)
ENTRIES = {
    "chunks": ("encode_chunks_dispatch", "encode_chunks_finalize"),
    "chunk": ("encode_chunk_dispatch", "encode_chunk_finalize"),
}
#: the entries whose dispatch takes a chunk mesh (``mesh=``): those a
#: cell on several cards may use
MESH_ENTRIES = ("chunks",)


def check(config: dict, traffic: dict, batch: int):
    """Refuse a codec setting that neither the program's call nor the
    reference takes, an entry the encoder has not, or the one-chunk
    entry with several chunks a dispatch."""
    for k, v in CONFIG_FIXED.items():
        if config.get(k) != v:
            raise ValueError(f"configuration {config['name']!r}: {k} = "
                             f"{config.get(k)!r}; the harness codes {v!r}")
    if config["search"] not in ("full", "hier"):
        raise ValueError(f"search {config['search']!r}")
    if traffic["entry"] not in ENTRIES:
        raise ValueError(f"entry {traffic['entry']!r}: the FVC encoder's "
                         f"are {sorted(ENTRIES)}")
    if traffic["entry"] == "chunk" and batch != 1:
        raise ValueError("entry 'chunk' dispatches one chunk at a time")


def make(config: dict, device):
    from flutpu_torch.codec.fvc import FvcEncoder
    return FvcEncoder(config["quality"], motion=config["motion"],
                      search_range=config["search_range"],
                      hier=config["search"] == "hier",
                      engine=config["engine"],
                      segmented=config["segmented"], device=device)


def entries(enc, entry: str):
    """(dispatch, finalize) of ``entry``: dispatch takes a dispatch's C
    chunks (C, F, H, W, 3) and returns a handle; finalize takes the
    handle and returns each chunk's bytes, in order."""
    dispatch, finalize = (getattr(enc, n) for n in ENTRIES[entry])
    if entry == "chunk":
        return (lambda frames: dispatch(frames[0])), \
            (lambda handle: [finalize(handle)])
    return dispatch, finalize


def reference(config: dict, frames, dtype=None) -> bytes:
    """One chunk's bytes by the plain reference, in float32 or
    ``dtype``."""
    import torch
    return ref_fvc.encode_chunk(frames, config["quality"],
                                config["search_range"],
                                config["search"] == "hier",
                                dtype or torch.float32)
