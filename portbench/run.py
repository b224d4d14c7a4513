"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up (imports, the library's load or first build, the inputs
made from ``--seed``, the cell's warm-up) is timed from the process's
start to the window's opening (``setup_s``); the window measures for
``--seconds``; then the outputs the window produced are compared with
the plain reference (:mod:`portbench.reference`).  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read
by ``metrics/<name>.py`` from the run's spans, counters and profiled
stretch.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit; the same numbers are the last lines of standard error.  With no
CUDA device, fewer devices than the cell asks for, or JAX or the JAX
package loaded once the window has closed, it exits non-zero and prints
no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere),
    to a clock tick."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = process_age_s()


class BenchmarkError(RuntimeError):
    """A run that must end with no result line."""


def check_guard(when: str) -> None:
    from portbench.common import guard

    found = guard.forbidden_loaded()
    if found:
        raise BenchmarkError(f"{when}: forbidden modules loaded: {found}")


def run_cell(cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """Run ``cell`` (:class:`portbench.manifest.Cell`) once; return the
    result object.  ``device="cpu"`` (tests only) runs the program's plain
    versions and skips the look for a card."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise BenchmarkError("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise BenchmarkError(f"{cell.name} needs {cell.chips} devices, "
                                 f"{torch.cuda.device_count()} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_guard("start-up")
    out = cell.runner().run(cell, seed=seed, seconds=seconds, trace=trace,
                            device=device)
    check_guard("after the window")
    setup_s = out["t_open"] - T_START + AGE_AT_START
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if not trace:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    else:
        for m in cell.per_layer:
            value = cell.reader(m)(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        from portbench.common import trace as trace_mod

        tr = out["trace"]
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": trace_mod.top_device_ops(tr),
                               "idle_gaps": trace_mod.idle_gaps(tr)}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in out["checks"].items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a whole number >= 0")
    from portbench import manifest

    try:
        result = run_cell(manifest.cell(args.workload), seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace))
    except BenchmarkError as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
