"""outside_engine_ms: the clients' mean latency less the mean span of
Engine.ft_search, both over the window: RESP parse and write, the handler
threads and the reader pool's queue."""


def read(run):
    spans = run.ft_search_spans()
    lat = run.latencies_s()
    if not spans or not lat.size:
        return None
    engine_s = sum(e - s for s, e in spans) / len(spans)
    return (float(lat.mean()) - engine_s) * 1e3
