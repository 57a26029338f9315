"""The control of ``correct``: the plain reference computed one
precision below the configuration's (8-bit coordinates for its int16,
timestamps relative to the job's first in 32 bits for its int64), put
in the program's place and judged by the same check against the exact
reference.  A sound check fails it.  The benchmark's runs do not run
this; it is run on the card at the cell's own size:

    python3 port_bench/control.py --workload honest-1024.batch \\
        --seeds 11 12 13

For each seed it takes the job a run with that seed checks (the DAG
made from the seed) and prints one JSON line with the
compared numbers and whether the control passed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import compare, spec  # noqa: E402

#: (coordinate bits, timestamp bits) of the control
CONTROL_BITS = (8, 32)


def control(bench, cell, seed: int, device="cuda", config=None,
            traffic=None) -> dict:
    config = config or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    entry = spec.entry(config["entry"])
    reference = spec.reference(config["reference"])
    dag = entry.Session(dict(config), dict(traffic, pool=0), seed,
                        device=device).own
    t = time.perf_counter()
    exact = reference.consensus(dag, device=device)
    low = reference.consensus(dag, device=device,
                              coord_bits=CONTROL_BITS[0],
                              ts_bits=CONTROL_BITS[1])
    checks = compare.check(compare.answers(low), exact)
    return {"seed": seed, "passed": compare.passed(checks),
            "seconds": time.perf_counter() - t,
            "checks": {c["name"]: c["value"] for c in checks}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    for seed in args.seeds:
        print(json.dumps(control(bench, cell, seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
