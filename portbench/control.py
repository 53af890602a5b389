"""The output check's control: the plain reference computed with TF32
operands (the nearest precision below the configuration's float32 with
TF32 off) put in the program's place, at the cell's own size, and held
against the float32 reference by the cell's own comparison.  Every number
the control reads must fail its limit.

    python3 portbench/control.py --workload image_1080p --seeds 1 2 3

prints one JSON line a seed: the numbers compared, their limits, and
whether the control failed them.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402


def control_checks(cell, seed: int, device: str = "cuda"):
    """The checks of one control run of `cell` on `seed`."""
    drv = cell.driver.Driver(cell.config, cell.traffic, seed, device,
                             control=True)
    try:
        drv.setup()
        for i in range(int(cell.traffic.get("compare", 0))):
            drv.kept.offer(lambda: (i, drv.serve(i)))
        return drv.check()
    finally:
        drv.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    harness.cache_env()
    cell = harness.resolve(args.workload, traced=False)
    for seed in args.seeds:
        checks = control_checks(cell, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_failed": any(not c.ok for c in checks),
                          "checks": {c.name: {"value": c.value,
                                              "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
