"""flutpu_torch.codec — the GPU encode paths.

Baseline JPEG: colorspace conversion, 4:2:0, 8x8 DCT and quantization run
in one CUDA kernel; Huffman coding of the blocks runs in a second; the
host compacts the word-aligned segments and wraps JFIF headers (native
C++ from flutpu.native). FVC chunks add temporal prediction on top:
version 1 accumulates coefficient residuals, version 2 runs the motion
search and chroma compensation kernels in the hybrid loop. Importing
this package registers ``cudajpegenc`` and ``cudafvcenc``.
"""

from .base import VideoEncoder
from .encoder import CudaJpegEnc
from .fvc import CudaFvcEnc, FvcDecoder, FvcEncoder
from .jpeg import JpegEncoder

__all__ = ["VideoEncoder", "CudaJpegEnc", "CudaFvcEnc", "FvcDecoder",
           "FvcEncoder", "JpegEncoder"]
