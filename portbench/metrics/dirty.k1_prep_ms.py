"""dirty.k1_prep_ms: host milliseconds in K1's input preparation, the
program's ``k1.prep`` spans (``ops/fused_gridder.grid_chunks_planes``:
tap indices, samples, slots, counts, occupancy, the conjugated table and
the colour planes' allocation), summed over the stretch of one dirty step
profiled with the host's operations.  Recording every host operation
slows the host, so this reads high against an untraced step."""

from portbench.common import spans


def read(trace):
    return spans.host_ms(trace.host_events, ("k1.prep",))
