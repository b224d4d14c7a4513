"""clean.idle_share: the share of one traced cube wave in which no
kernel, copy or memset ran on the device (profiler trace), %."""


def read(trace):
    return trace.idle_share()
