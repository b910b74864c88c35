"""Where an entry point's input runs.

A ``torch.Tensor`` stays on its device: a CPU tensor is the caller's request
for the CPU (the kernels' plain versions), a CUDA tensor runs the kernels.
Anything else (a NumPy array, a list) goes to the current CUDA device, so a
NumPy frame, which is what tpuimg's users pass, runs on the card. Without a
card such an input raises ``DeviceError``; it never falls back to the CPU.
"""

from __future__ import annotations

import torch

from tpuimg_torch.core.validate import DeviceError


def as_image(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is; anything else on ``like``'s
    device when given (a table or a second operand follows the image), else
    on the current CUDA device."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, device=like.device)
    if not torch.cuda.is_available():
        raise DeviceError(
            f"a {type(x).__name__} input runs on the CUDA card and there is "
            f"none; pass a CPU torch.Tensor (torch.from_numpy(a)) to run on "
            f"the CPU")
    return torch.as_tensor(x, device=torch.device(
        "cuda", torch.cuda.current_device()))
