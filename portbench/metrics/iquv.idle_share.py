"""iquv.idle_share: the share of the traced stretch of full-Stokes dirty
steps in which no kernel, copy or memset ran on the device (profiler
trace), %."""


def read(trace):
    return trace.idle_share()
