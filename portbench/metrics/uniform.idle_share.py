"""uniform.idle_share: the share of the traced stretch of dirty steps
under uniform weights in which no kernel, copy or memset ran on the
device (profiler trace), %."""


def read(trace):
    return trace.idle_share()
