"""flutpu_torch.parallel — GOP-chunk parallelism on CUDA devices (port of
flutpu/parallel).

``mesh`` names the devices that hold the ``chunk`` axis, ``gop`` encodes
C GOP chunks in one dispatch (JPEG coefficients, or the FVC chunk codec
with a chunk axis through every kernel), ``multihost`` carries the chunk
assignment and stitch arithmetic across processes.
"""
