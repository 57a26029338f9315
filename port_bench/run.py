"""The port's benchmark: runs one cell of ``BENCHMARK.json`` once and
prints one JSON result line.

    python3 port_bench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.  It
exits 2 without a result where CUDA is missing or has too few cards, and
1 where the run loads JAX or the JAX package.  The benchmark's own
builds (``port_bench/_build/``) and the program's (its ``_build/``) stay
inside the checkout.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here, before torch

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from port_bench import spec

    bench = spec.load()
    cell = spec.workload(bench, args.workload)

    # keep libraries that would load JAX by themselves from doing so
    os.environ.setdefault("USE_FLAX", "0")
    # one host thread for torch's CPU work: the run is one process, and
    # idle worker threads spinning beside the driving thread spread its
    # timings
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("port_bench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"port_bench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    from port_bench.harness import run_cell

    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), T_START)
    bad = spec.forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
