"""The readings that the limits of `correct` are set from, in one process.

For one cell and a list of seeds, on the card:

  * program: a run of the cell as the benchmark runs it (a short window at
    the cell's own load), its numbers;
  * control: the reference put in the program's place at the precision
    below the configuration's (bf16 -> float8 e4m3, emulated by rounding;
    f32 -> TF32), against the reference in float32;
  * fault:<name>: a run with the fault planted under the timed path
    (faults.py), its numbers.

    python3 benchmark/control.py --workload bf16-infer-b256 --seeds 1,2,3 \\
        --kinds program,control --seconds 2

One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import faults  # noqa: E402
from benchmark.lib import harness  # noqa: E402

CONTROL_PRECISION = {"bf16": "fp8", "f32": "tf32"}


def readings(cell, seed: int, kind: str, seconds: float, device) -> dict:
    driver = harness.load_driver(cell)
    ctx = harness.Context(cell, seed, seconds, False, device, time.monotonic(), log=lambda msg: None)
    if kind == "control":
        return driver.control(ctx, CONTROL_PRECISION[cell.config["precision"]])
    if kind == "program":
        out = driver.run(ctx)
    else:
        with faults.planted(kind.split(":", 1)[1], cell.arch):
            out = driver.run(ctx)
    return dict(out.readings.numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--kinds", default="program,control",
                    help="comma-separated: program, control, fault:<name>")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    cell = harness.resolve(args.workload)
    device = torch.device("cuda", 0)
    for kind in args.kinds.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.monotonic()
            nums = readings(cell, seed, kind, args.seconds, device)
            print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **nums,
                              "s": round(time.monotonic() - t0, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
