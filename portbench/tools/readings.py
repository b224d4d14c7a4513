"""The readings a cell's limit is set from, on the chip.

    python3 -m portbench.tools.readings --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--control]

For each seed, one run of the cell with a short window (its set-up, its
window and its comparison, as the benchmark runs them) and, with
``--control``, the control: the reference put in the program's place at
the next precision down (TF32 products for float32), judged by the same
comparison.  One JSON line per seed with each number compared, then one
with the largest program reading and the smallest control reading.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from portbench import manifest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.cell(args.workload)
    program, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = cell.runner().run(cell, seed=seed, seconds=args.seconds,
                                trace=False, device="cuda",
                                control=args.control)
        line = {"seed": seed, "attempted": out["attempted"],
                "correct": out["correct"],
                "program": {k: v for k, (v, _) in out["checks"].items()},
                "control": out.get("control")}
        for k, v in line["program"].items():
            program.setdefault(k, []).append(v)
        for k, v in (line["control"] or {}).items():
            control.setdefault(k, []).append(v)
        print(json.dumps(line), flush=True)
    print(json.dumps({
        "workload": args.workload, "kind": torch.cuda.get_device_name(0),
        "program_max": {k: max(v) for k, v in program.items()},
        "control_min": {k: min(v) for k, v in control.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
