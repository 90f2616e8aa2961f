"""flutpu_torch.ttml.render — the TTML renderer (port of
flutpu/ttml/render).

Host text shaping (fonts/layout) + device compositing in PyTorch (atlas,
device, composite) behind the ``cudattmlrender`` element (render_el), and
``cudaoverlaycompositor`` (overlay_el).
"""

from .render_el import TTMLRender
from .overlay_el import OverlayCompositor
from .composite import compose_window, overlay_on_frames, overlay_on_planes
from .layout import draw_region_layer

__all__ = ["TTMLRender", "OverlayCompositor", "compose_window", "overlay_on_frames",
           "overlay_on_planes", "draw_region_layer"]
