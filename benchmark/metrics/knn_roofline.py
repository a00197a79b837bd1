"""knn_roofline (%): the least time that the KNN launches in the traced
slice need for their work (benchmark/work.py: the admitted rows read once in
the configuration's corpus dtype, their norms, the queries and the k outputs,
and 2 B R d operations at the type's peak), over the device's busy time in
the same slice (the union of all its activity). A launch counts when its
span lies inside the slice. A slice whose kernels the profiler lost has
nothing to read."""

from benchmark import tracing, work


def read(run):
    sl = run.device_slice
    peak = work.peaks(run.device_kind)
    if not tracing.has_kernels(sl) or peak is None:
        return None
    busy = tracing.busy_seconds(sl)
    dtype = work.corpus_dtype(run.config)
    dim = int(run.config["dim"])
    least = sum(work.least_seconds(s.rows, run.rows_admitted(s), dim, s.k,
                                   dtype, peak)
                for s in run.search_batch_spans()
                if sl.start <= s.start and s.end <= sl.end)
    if least <= 0 or busy <= 0:
        return None
    return least / busy * 100.0
