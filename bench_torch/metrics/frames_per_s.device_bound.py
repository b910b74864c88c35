"""``frames_per_s`` of a cell whose device does nearly all the work, so
that the host's noise barely reaches it and a tight bound holds."""

from bench_torch.metrics.frames_per_s import read  # noqa: F401
