"""clean.clean_share: the share of the waves' seconds spent in their
CLEAN stages (``parallel/cube._clean_stage``), each stage synchronised on
both sides and timed by the benchmark, %."""


def read(trace):
    waves = sum(trace.span_seconds("wave"))
    stages = sum(trace.span_seconds("clean.stage"))
    if waves <= 0 or stages <= 0:
        return None
    return 100.0 * stages / waves
