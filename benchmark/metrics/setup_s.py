"""setup_s: process start to window start (kernel build, data, load,
publish and warm-up)."""


def read(run):
    return run.setup_s
