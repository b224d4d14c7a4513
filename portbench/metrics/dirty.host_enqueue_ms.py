"""dirty.host_enqueue_ms: the host's milliseconds per dirty step, from the
step's call until its last launch has returned (no synchronise), as the
mean over every step of the window (the benchmark's ``dirty.step``
spans).  Where the host enqueues more slowly than the device runs, this
is the step time; the slice loop's enqueue (``parallel/multichannel``)
is what it measures."""


def read(trace):
    spans = trace.span_seconds("dirty.step")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
