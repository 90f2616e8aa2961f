"""flutpu_torch.parallel — GOP-chunk parallelism on CUDA devices (port of
flutpu/parallel).

``mesh`` names the shard devices of the ``chunk`` axis and, for row
stripes, of the ``spatial`` axis (a device may repeat), ``gop`` encodes
C GOP chunks in one dispatch per chunk shard (JPEG coefficients, or the
FVC chunk codec with a chunk axis through every kernel, its frames cut
into row stripes on a spatial mesh), ``multihost`` carries the chunk
assignment and stitch arithmetic across processes.
"""
