"""The program's own spans in a profiled stretch, and the device work each
launched.

The program names its layers with ``katsdpimager_tpu_torch.profiling.
profile`` ranges, which a ``torch.profiler`` run with CPU activity records
as ``user_annotation`` events.  A kernel, copy or memset belongs to a
span when the runtime call that launched it (a ``cuda_runtime`` or
``cuda_driver`` event, matched to the device event by
``args.correlation``) starts inside the span: work launched before the
span, still running while it is open, is not its own.
"""

from __future__ import annotations

import bisect

from portbench.common.trace import DEVICE_CATEGORIES, union_s

#: Trace categories of the host's calls that launch device work.
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def spans(events, names) -> list:
    """(start us, end us) of each of the program's spans named in
    ``names``, in order of start."""
    return sorted((ev["ts"], ev["ts"] + ev.get("dur", 0)) for ev in events
                  if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                  and ev.get("name") in names)


def host_ms(events, names):
    """Milliseconds the host spent in the spans named in ``names``, summed;
    None where there is no such span."""
    found = spans(events, names)
    if not found:
        return None
    return sum(e - s for s, e in found) / 1e3


def launched(events, names) -> list:
    """(start us, end us) of each device operation launched inside a span
    named in ``names``."""
    inside = spans(events, names)
    starts = [s for s, _ in inside]
    owned = set()
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in LAUNCH_CATEGORIES:
            continue
        i = bisect.bisect_right(starts, ev["ts"]) - 1
        if i >= 0 and ev["ts"] <= inside[i][1]:
            owned.add(ev.get("args", {}).get("correlation"))
    owned.discard(None)
    return [(ev["ts"], ev["ts"] + ev["dur"]) for ev in events
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES
            and ev.get("args", {}).get("correlation") in owned]


def device_ms(events, names):
    """Milliseconds in which the device ran work launched inside the spans
    named in ``names`` (the union of its intervals); None where no such
    work is in the trace."""
    work = launched(events, names)
    if not work:
        return None
    return 1e3 * union_s(work)
