"""The control of a cell's check: the plain reference, computed in
bfloat16 (the precision below the configurations' float32), put in the
program's place and judged by the same comparison.  Every number it
prints beside its limit is an upper reading; `correct` has to come out
false.  Not part of a benchmark run.

    python3 portbench/control.py --workload p1_512.solve --seeds 1 2 3

With --fault NAME it runs the port instead, with that fault of
portbench/faults.py planted underneath (each seed a run of --seconds):
the fault's readings at the cell's own size.

With --floor it also prints, for a configuration whose discrete solution
is known (constant kappa: u* itself at the nodes), the check's numbers
for u* rounded to float32 and to bfloat16: what rounding alone reads.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--floor", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import main as harness
    from portbench.harness import spec
    from portbench.harness.systems import coefficients, reference_problem

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    config = spec.config(bench, cell["config"])
    traffic = dict(spec.traffic(cell["traffic"]), warmup=1)
    for seed in args.seeds:
        if args.fault is None:
            res = harness.run_cell(args.workload, seed, args.seconds, False,
                                   device="cuda", system="control",
                                   traffic=traffic)
        else:
            from portbench.faults import FAULTS
            with FAULTS[args.fault]():
                res = harness.run_cell(args.workload, seed, args.seconds,
                                       False, device="cuda")
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": res["correct"],
                          "compared": res["compared"]}), flush=True)
        if args.floor and config["problem"].get("kappa") is None:
            ref = spec.reference(config["reference"])
            lo, hi = config["problem"]["coef_range"]
            p = reference_problem(config, coefficients(seed, 0, lo, hi))
            x, y, z = ref.node_coords(p, 0, p.n + 1, torch.float64,
                                      "cuda")
            for dt in (torch.float32, torch.bfloat16):
                u = p.exact(x, y, z).expand((p.n + 1,) * 3).to(dt)
                rs, r0, m, m0 = ref.residual_norms(p, u)
                print(json.dumps({"seed": seed, "floor": str(dt),
                                  "res_rel": rs / r0, "res_max": m / m0}),
                      flush=True)
                del u
    return 0


if __name__ == "__main__":
    sys.exit(main())
