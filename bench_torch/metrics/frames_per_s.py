"""Frames the window completed over its seconds: from the first call to the
moment the caller saw its last frame complete."""


def read(run):
    return run.frames / run.window_s if run.frames else None
