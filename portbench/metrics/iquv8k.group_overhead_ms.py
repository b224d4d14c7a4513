"""iquv8k.group_overhead_ms: device milliseconds a dirty step of the
polarisation-independent part of K1's prep that the second and later
polarisation groups of each W slice repeat, over the stretch of one step
profiled with the host's operations.

The program grids a slice's polarisations in groups that fit its
accumulator cap (``fused_gridder.slice_planes``), each group's prep and
K1 inside a ``k1.group`` span.  In each group's prep, the work that no
polarisation changes (tap indices, chunk slots, counts, occupancy, the
conjugated table) is the ``k1.prep_shared`` span.  A slice's first group
(the first ``k1.group`` span inside its ``multichannel.slice`` span)
needs that work once; what the later groups' ``k1.prep_shared`` spans
launch (the union of its device intervals) repeats it, and is what
working it out once a slice would save.  The samples each group builds
for its own polarisations are not counted: one group would build them
for all.  Nothing is read where no slice took a second group, or where
the program has no ``k1.prep_shared`` span.
"""

from portbench.common import spans

SHARED = "k1.prep_shared"


def read(trace):
    events = trace.host_events
    slices = spans.spans(events, ("multichannel.slice",))
    later, seen = [], set()
    for start, end in spans.spans(events, ("k1.group",)):
        owner = next((i for i, (s, e) in enumerate(slices)
                      if s <= start <= e), None)
        if owner is not None and owner in seen:
            later.append((start, end))
        seen.add(owner)

    def counted(ev):
        if ev.get("name") != SHARED or ev.get("cat") != "user_annotation":
            return True
        return any(s <= ev["ts"] <= e for s, e in later)

    return spans.device_ms([ev for ev in events if counted(ev)], (SHARED,))
