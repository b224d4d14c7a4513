"""uniform.weight_grid_ms: milliseconds per dirty step in the imaging
weights' grid (``parallel/multichannel.weight_grid``: each channel's
statistical weights summed into UV cells), each call synchronised on
both sides by the benchmark (``weight_grid`` spans), summed over the
window's steps and divided by them."""


def read(trace):
    spans = trace.span_seconds("weight_grid")
    steps = len(trace.span_seconds("dirty.step"))
    if not spans or not steps:
        return None
    return 1e3 * sum(spans) / steps
