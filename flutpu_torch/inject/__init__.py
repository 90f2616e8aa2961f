"""flutpu_torch.inject — dynamic pipeline rebuild (reference: injectbin
plugin); a copy of flutpu.inject on the port's core."""

from .injectbin import InjectBin

__all__ = ["InjectBin"]
