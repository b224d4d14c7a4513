"""Host cost of one use of the port's span, ``katsdpimager_tpu_torch.
profiling.profile``: nanoseconds per ``with profile(name): pass``, with
nothing listening (the shared no-op), with a ``CollectProfiler``
installed, and under ``torch.profiler`` recording the CPU's activity.
Each is the least over several repeats of many uses, less an empty loop.

    PYTHONPATH=. python scripts/span_cost.py

prints one JSON line.  It runs on the host's CPU and needs no card.
"""

import json
import platform
import time

import torch

from katsdpimager_tpu_torch import profiling


def ns_per_use(uses: int, repeats: int = 7) -> float:
    def loop(body: bool) -> float:
        t = time.perf_counter_ns()
        if body:
            for _ in range(uses):
                with profiling.profile("k1.launch"):
                    pass
        else:
            for _ in range(uses):
                pass
        return time.perf_counter_ns() - t

    best = min(loop(True) for _ in range(repeats))
    empty = min(loop(False) for _ in range(repeats))
    return (best - empty) / uses


def main() -> None:
    out = {"cpu": platform.processor() or platform.machine(),
           "torch": torch.__version__,
           "off_ns": ns_per_use(1_000_000)}
    prof = profiling.CollectProfiler()
    with profiling.installed(prof):
        out["collect_ns"] = ns_per_use(20_000)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["torch_profiler_ns"] = ns_per_use(5_000, repeats=3)
    out["off_ns_again"] = ns_per_use(1_000_000)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
