"""qps (requests/s): replies answered in the window over its seconds."""


def read(run):
    return len(run.answered()) / run.seconds
