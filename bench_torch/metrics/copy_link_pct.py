"""The copies between the host and the card against the host link, %: the
least time of a frame's copies over the sum of each copy's own device time
a frame.

The work: the u8 frame up and the u8 frame down, ``height * width`` bytes
each way, at the link's 64 GB/s per direction (PCIe Gen5 x16, NVIDIA's
H100 SXM data sheet). Summing each copy's own time, and not the time in
which some copy ran, keeps the share at or under 100% when a copy up and a
copy down run at once, each on its own direction of the link. The bytes are
counted from the configuration's shapes, not from the copies that happen to
run.
"""

from bench_torch.metrics.copy_device_ms import copies

LINK_BYTES_PER_S = 64e9  # each direction


def least_ms(cfg):
    """A frame's copy up and copy down, each at the link's rate, ms."""
    return 2 * cfg["height"] * cfg["width"] / LINK_BYTES_PER_S * 1e3


def read(run):
    if run.trace is None:
        return None
    moved = copies(run.trace)
    if not moved:
        return None
    own_ms = sum(end - start for _, start, end in moved) / run.trace.frames
    return 100.0 * least_ms(run.config) / (own_ms * 1e-3)
