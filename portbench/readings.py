"""The readings that a cell's limits are set from, many seeds in one
process (set-up is paid once per seed, compiling once):

    python3 portbench/readings.py --workload <cell> --modes program control \
        --seconds 5 --seeds 11 12 13 ...

``--modes`` lists whose readings to take on each seed, after one
set-up and one short window at the cell's own load: ``program`` (the
program's timed path, judged as a run judges it) and ``control`` (the
reference at the precision below the configuration's in the program's
place).
``--fault`` plants one of ``faults.py``'s faults under the program.
Prints one JSON line a seed with every number the cell's kind compares,
judged or not, for each mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from portbench import bench, faults, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--modes", nargs="+", default=["program"],
                   choices=("program", "control"))
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(faults.FAULTS),
                   help="plant this fault under the program's timed path")
    args = p.parse_args(argv)
    config = bench.cell(args.workload).config
    import torch
    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        res = run.execute(args.workload, seed, args.seconds, False,
                          modes=tuple(args.modes), faults=(
                              faults.FAULTS[args.fault](config)
                              if args.fault else None))
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": res["correct"],
                          "failed": res["failed"],
                          "readings": res["readings"],
                          "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
