"""flutpu_torch — flutpu's device paths in PyTorch and CUDA for NVIDIA
Hopper GPUs.

A second package beside ``flutpu``: it keeps flutpu's module names, so
``flutpu_torch.codec.ops.entropy`` is the counterpart of
``flutpu.codec.ops.entropy``. It imports neither jax nor anything of
``flutpu``: it carries its own copy of the dataflow core (``core``:
elements, caps, pads, ``parse_launch``, the registry) and its own loader
of the repository's C++ library (``native``, built from ``native/`` at
first use). Each Pallas TPU kernel on a ported path has a hand-written
CUDA kernel under ``csrc/``, built with nvcc at first use
(``_build.py``); tensors on the CPU take each kernel's plain PyTorch
version.

Ported: the baseline-JPEG GOP encoder
(``codec.jpeg.JpegEncoder``, both bitstream layouts) and its element
``cudajpegenc``; the FVC chunk codec, version 1 and version 2 with P and
B frames (``codec.fvc.FvcEncoder``, ``FvcDecoder``) and its element
``cudafvcenc``; subtitle burn-in (``ttml``); GOP-chunk parallelism
(``hype``: the ``hype`` bin with the port's encoders in its branches,
and ``cudahype``, C chunks per dispatch; ``parallel``; ``inject``:
``injectbin``); the decoders ``cudajpegdec`` and ``cudafvcdec``; the ABR
ladder ``cudafvcladderenc`` (``codec.ladder``) with copies of flutpu's
``fluc`` (the bandwidth meter) and ``io`` (the downloader); the
command-line tools ``python -m flutpu_torch.launch`` and ``python -m
flutpu_torch.inspect``. ``import flutpu_torch`` registers the encoders
in the port's registry (``flutpu_torch.core``), which loads the other
plugins on first use.
"""

__version__ = "0.1.0"

from . import codec  # noqa: F401  (registers cudajpegenc, cudafvcenc)
