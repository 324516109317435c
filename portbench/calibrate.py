"""Readings for the limits of ``correct``: one cell on several seeds in one
process (the kernels built once), printing per run one JSON line with
every number the check compares and its control's reading.

    python -m portbench.calibrate --workload <cell> --seeds 11,12,13 \
        --seconds 12 [--fault state|half|lanes|altered|disparity]

The benchmark's own runs never run this. ``--fault`` plants one of
``faults.py``'s faults under the timed path, to read what it gives at the
cell's own size.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--fault", default=None,
                    help="one of faults.py's: state, half, lanes, "
                    "altered, disparity")
    args = ap.parse_args(argv)
    run.one_thread()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 1
    from portbench import faults
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = faults.planted(args.fault) if args.fault \
            else contextlib.nullcontext()
        with ctx:
            r = run.run_cell(args.workload, seed, args.seconds, False,
                             t_start=t0)
        r.pop("forbidden_modules")
        line = {"seed": seed, "fault": args.fault, "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "readings": r["readings"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
