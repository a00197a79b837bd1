"""reader_wait_ms: the mean time a request waits on the reader pool's
handoffs, by the program's own spans: ``reader.queue`` (submitted to a
reader thread starting it) plus ``reader.return`` (the reply ready to the
handler resuming)."""

from benchmark import program_spans


def read(run):
    return program_spans.request_mean_ms(run, {
        "reader.queue": 1, "reader.return": 1})
