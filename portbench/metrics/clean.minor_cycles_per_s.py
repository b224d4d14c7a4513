"""clean.minor_cycles_per_s: the minor cycles the waves report
(``WaveResult.minor``, summed) over the seconds of their CLEAN stages
(``ops/clean``), cycles/s."""


def read(trace):
    stages = sum(trace.span_seconds("clean.stage"))
    minor = trace.counters.get("minor", 0)
    if stages <= 0 or minor <= 0:
        return None
    return minor / stages
