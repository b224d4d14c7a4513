"""dirty.launch_ms: host milliseconds in the wrappers of K1-K4, the
program's ``k1.launch``, ``k2.launch``, ``k3.launch`` and ``k4.launch``
spans (argument checks, the library's load, the call into it), summed
over the stretch of one dirty step profiled with the host's operations.
Recording every host operation slows the host, so this reads high
against an untraced step."""

from portbench.common import spans

SPANS = ("k1.launch", "k2.launch", "k3.launch", "k4.launch")


def read(trace):
    return spans.host_ms(trace.host_events, SPANS)
