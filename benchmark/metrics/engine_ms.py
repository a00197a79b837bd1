"""engine_ms: the mean span of Engine.ft_search (parse, plan, filter mask,
batcher wait, launch, reply) of the calls that ended in the window."""


def read(run):
    spans = run.ft_search_spans()
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) * 1e3
