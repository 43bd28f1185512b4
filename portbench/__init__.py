"""The port's benchmark: one cell of BENCHMARK.json run once per call.

Run as `python3 portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` from the root of a checkout.  Everything that belongs
to one configuration, traffic mix, per-layer metric or dispatch entry's
work count sits in a file of its own under this folder and is found by
the name that BENCHMARK.json gives it.
"""
