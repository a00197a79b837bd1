"""batcher_wait_ms: the mean time a request waits on the query batcher, by
the program's own spans: ``batcher.queue`` (submitted to its launch
starting) plus ``batcher.return`` (its batch settled to the submitter
resuming)."""

from benchmark import program_spans


def read(run):
    return program_spans.request_mean_ms(run, {
        "batcher.queue": 1, "batcher.return": 1})
