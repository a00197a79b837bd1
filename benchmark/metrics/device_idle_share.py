"""device_idle_share (share): 1 - the union of device activity over the
traced slice's wall time (torch.profiler, CUDA activity only); a slice
whose kernels the profiler lost has nothing to read."""

from benchmark import tracing


def read(run):
    sl = run.device_slice
    if not tracing.has_kernels(sl):
        return None
    return 1.0 - tracing.busy_seconds(sl) / (sl.end - sl.start)
