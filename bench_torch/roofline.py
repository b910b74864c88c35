"""The least time a piece of work can take on the card, from its shapes.

Peaks from NVIDIA's data sheet for the H100 SXM at its full 700 W: HBM at
3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores. Integer compares
and adds count at the float32 rate. Bytes count each input read once and
each output written once, whatever a kernel reads again; operations count
what the function needs, whatever a kernel does.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# a window sum is a running sum: an add and a subtract a pixel, in the row
# and in the column pass, so it does not grow with the radius
BOX_SUM_OPS = 2 * 2


def least_ms(moved: float, ops: float) -> float:
    """The larger of the bytes at the HBM rate and the operations at the
    float32 rate, in ms."""
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def gauss_ops(r: int) -> int:
    """Operations a gaussian output pixel takes: a row and a column pass,
    r + 1 multiplies and 2r adds each (the symmetric form)."""
    return 2 * (3 * r + 1)


def guided_ops(planes: int = 4) -> int:
    """Operations a guided output pixel takes: window sums of ``planes``
    planes (4 with a distinct guide, 2 self-guided) and of a and b, two
    products, a and b, and q."""
    return BOX_SUM_OPS * (planes + 2) + 12


def share(least: float, device_ms: float) -> float | None:
    """The roofline share in %, None where no kernel did the work."""
    return 100.0 * least / device_ms if device_ms > 0 else None
