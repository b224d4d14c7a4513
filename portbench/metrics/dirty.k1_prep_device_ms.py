"""dirty.k1_prep_device_ms: device milliseconds (the union of their
intervals) of the kernels, copies and memsets that the program's
``k1.prep`` spans launched, over the stretch of one dirty step profiled
with the host's operations: the device's share of K1's input
preparation, which runs again every step on inputs that do not change."""

from portbench.common import spans


def read(trace):
    return spans.device_ms(trace.host_events, ("k1.prep",))
