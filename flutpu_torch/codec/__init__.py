"""flutpu_torch.codec — the GPU encode and decode paths.

Baseline JPEG: colorspace conversion, 4:2:0, 8x8 DCT and quantization run
in one CUDA kernel; Huffman coding of the blocks runs in a second, per
segment of 16 blocks or (``segmented=False``) per block; the host
compacts the word-aligned segments (the port's native C++ library) or
byte-stuffs the device-joined stream, and wraps JFIF headers. FVC
chunks add temporal prediction on top: version 1 accumulates coefficient
residuals, version 2 runs the motion search and chroma compensation
kernels in the hybrid loop. The decode side reconstructs in plain
PyTorch on the device after the host's entropy decode. The ABR ladder
scales each chunk on the device per rung and encodes every rung. Importing
this package registers ``cudajpegenc``, ``cudafvcenc``,
``cudafvcladderenc``, ``cudajpegdec``, ``cudafvcdec`` and the host-only
``avimux`` and ``avidemux``.
"""

from .avimux import AviDemux, AviMux
from .base import VideoEncoder
from .decoders import CudaFvcDec, CudaJpegDec
from .encoder import CudaJpegEnc
from .fvc import CudaFvcEnc, FvcDecoder, FvcEncoder
from .jpeg import JpegEncoder
from .ladder import CudaFvcLadderEnc, Rung, encode_ladder_chunk, parse_rungs

__all__ = ["AviDemux", "AviMux", "VideoEncoder", "CudaFvcDec", "CudaJpegDec",
           "CudaJpegEnc", "CudaFvcEnc", "CudaFvcLadderEnc", "FvcDecoder",
           "FvcEncoder", "JpegEncoder", "Rung", "encode_ladder_chunk",
           "parse_rungs"]
