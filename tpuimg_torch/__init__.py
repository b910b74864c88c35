"""tpuimg_torch — the PyTorch/CUDA port of tpuimg for NVIDIA Hopper.

The JAX package ``tpuimg`` beside it is the reference; this package mirrors
its layout and public functions, and holds each op to tpuimg's contracts.
Every TPU kernel on a ported path becomes a hand-written CUDA kernel
(``tpuimg_torch/csrc``), built at first use; a CPU tensor runs each kernel's
plain PyTorch version instead. Importing this package imports neither JAX nor
``tpuimg``. ``python -m tpuimg_torch`` is the demo and autotest CLI
(``cli.py``), on the card by default.
"""

from tpuimg_torch.ops import (
    box_filter, clahe, dilate, erode, gaussian, guided_filter, hist_equalize,
    integral, morph_close, morph_open)
from tpuimg_torch.pipeline import enhance
from tpuimg_torch.host import enhance_host

__version__ = "0.1.0"

__all__ = ["box_filter", "clahe", "dilate", "enhance", "enhance_host", "erode",
           "gaussian", "guided_filter", "hist_equalize", "integral",
           "morph_close", "morph_open"]
