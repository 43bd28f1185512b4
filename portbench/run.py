"""Run one cell of BENCHMARK.json once on this machine's CUDA card.

    python3 portbench/run.py --workload p1_512.solve --seed 12345 \
        --seconds 30 --trace 0

Prints the result as the last line of standard output (one JSON object)
and each number that decides `correct` beside its limit as the last lines
of standard error.  Exits non-zero, printing no result, where there is no
CUDA card (or fewer than the cell asks for), where the port or the
benchmark's files are missing, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import importcheck, spec
    from portbench.harness import main as harness

    cell = spec.workload(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    found = importcheck.forbidden_loaded()
    if found:
        print(f"loaded in the run's process: {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
