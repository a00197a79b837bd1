"""launch_host_ms: the mean host time of a launch, by the program's own
spans: ``flat.search_batch`` less ``flat.sync`` (the host blocked on the
device's results), over the launches that ended in the window."""

from benchmark import program_spans


def read(run):
    return program_spans.launch_host_ms(run)
