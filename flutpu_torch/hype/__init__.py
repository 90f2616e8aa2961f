"""flutpu_torch.hype — GOP-chunk parallel encoder (HYbrid Parallel
Encoder) on the port's core.

The host elements are copies of flutpu's: fixed-GOP chunk boundaries
(scenedetector), round-robin scatter with per-branch queues and forced
keyframes (outputselector), strictly ordered N→1 reassembly
(scenecollector), composed in the ``hype`` bin, whose branches take the
port's encoders (``cudajpegenc``, ``cudafvcenc``), each on its own
streaming thread. ``cudahype`` runs the same contract as one dispatch of
C chunks on a CUDA device (flutpu's ``tpuhype``).
"""

from .events import SceneNewEvent, SCENE_NEW_EVENT_NAME
from .scenedetector import SceneDetector
from .outputselector import OutputSelector
from .scenecollector import SceneCollector
from .hypebin import Hype
from .cuda import CudaHype

__all__ = ["SceneNewEvent", "SCENE_NEW_EVENT_NAME", "SceneDetector",
           "OutputSelector", "SceneCollector", "Hype", "CudaHype"]
