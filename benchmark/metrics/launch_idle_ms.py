"""launch_idle_ms: the mean time the device idles inside a launch: each
``flat.search_batch`` span (the program's own) that lies in the traced
slice, less the part of it that the union of the slice's device operations
covers, on the clock both share. A slice whose kernels the profiler lost has
nothing to read."""

from benchmark import program_spans


def read(run):
    return program_spans.launch_idle_ms(run, run.device_slice)
