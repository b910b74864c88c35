"""Launch arithmetic (port of ``tpuimg.core.layout``: ``cdiv``, ``round_up``).

The TPU (8, 128) padding helpers have no counterpart: the CUDA kernels mask
their ragged edges themselves.
"""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    """Ceiling division (reference ``iDivUp``)."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m (reference ``iAlignUp``)."""
    return cdiv(x, m) * m
