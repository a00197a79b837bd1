"""engine_self_ms: the mean time a request spends in the engine outside
the batcher and the launch, by the program's own spans: its
``engine.ft_search`` less ``batcher.queue``, ``batcher.return`` and the
``flat.search_batch`` launches it waited on (parse, plan, filter mask,
neighbours and reply shaping)."""

from benchmark import program_spans


def read(run):
    return program_spans.request_mean_ms(run, {
        "engine.ft_search": 1, "batcher.queue": -1, "batcher.return": -1,
        "launch": -1})
