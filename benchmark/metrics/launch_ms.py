"""launch_ms: the mean span of FlatVectorIndex.search_batch (it returns host
arrays, so the span holds the device program) of the calls that ended in the
window."""


def read(run):
    spans = run.search_batch_spans()
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / len(spans) * 1e3
