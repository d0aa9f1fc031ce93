"""PTV dataset registry names (copy of ``vtm/data/ptv.py``; upstream
slowfast/datasets/ptv_datasets.py: Ptvkinetics :142-273, Ptvcharades
:311-452, Ptvssv2 :454-595).

Upstream loads the same datasets as the native Kinetics, Charades and SSv2
classes through pytorchvideo's ``LabeledVideoDataset`` (clip samplers and
torchvision-style transforms), wrapped back into the slowfast tuple by
``PTVDatasetWrapper`` (:42-91). The sampling it reproduces (one random clip
a video with random crop, scale and flip for train and val; uniformly
spaced clips with centre crops for test) is what the native datasets do,
so, as in ``vtm``, the names are aliases of the native datasets: a config
that sets ``TRAIN.DATASET`` / ``TEST.DATASET`` to ``ptvkinetics`` (etc.)
builds and yields the same items.
"""

from __future__ import annotations

from vtm_torch.data.charades import Charades
from vtm_torch.data.kinetics import Kinetics
from vtm_torch.data.loader import register_dataset
from vtm_torch.data.ssv2 import Ssv2


@register_dataset("ptvkinetics")
class Ptvkinetics(Kinetics):
    """ptv_datasets.py:142-273 — see module docstring."""


@register_dataset("ptvcharades")
class Ptvcharades(Charades):
    """ptv_datasets.py:311-452 — see module docstring."""


@register_dataset("ptvssv2")
class Ptvssv2(Ssv2):
    """ptv_datasets.py:454-595 — see module docstring."""
