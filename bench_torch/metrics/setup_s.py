"""From the run's first statement to its first timed call: imports, the
program's kernel build or load, the ring made on the card and the warm-up."""


def read(run):
    return run.setup_s
