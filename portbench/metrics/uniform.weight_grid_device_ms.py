"""uniform.weight_grid_device_ms: device milliseconds (the union of their
intervals) of the kernels, copies and memsets that the program's
``multichannel.weights`` spans launched (``parallel/multichannel.
_density``: the weight grid and ``1 / W``), over the stretch of one
dirty step under uniform weights profiled with the host's operations.
Nothing synchronises around the weights: the device's own time."""

from portbench.common import spans


def read(trace):
    return spans.device_ms(trace.host_events, ("multichannel.weights",))
