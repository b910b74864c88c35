"""NumPy oracles with the reference's semantics (port of ``tpuimg.oracle``)."""

from tpuimg_torch.oracle.numpy_ref import (
    box_filter_ref,
    clahe_ref,
    close_ref,
    dilate_ref,
    erode_ref,
    gaussian_ref,
    guided_filter_ref,
    hist_equalize_ref,
    integral_ref,
    open_ref,
)

__all__ = [
    "box_filter_ref", "clahe_ref", "close_ref", "dilate_ref", "erode_ref",
    "gaussian_ref", "guided_filter_ref", "hist_equalize_ref", "integral_ref",
    "open_ref",
]
