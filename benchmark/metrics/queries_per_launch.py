"""queries_per_launch: query rows over calls of FlatVectorIndex.search_batch
that ended in the window (the batcher's coalescing)."""


def read(run):
    spans = run.search_batch_spans()
    if not spans:
        return None
    return sum(s.rows for s in spans) / len(spans)
