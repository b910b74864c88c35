"""Host time inside the entry point, from the caller entering it to its
return, summed over the window's frames, over the frames, ms."""


def read(run):
    return run.host_s / run.frames * 1e3 if run.frames else None
