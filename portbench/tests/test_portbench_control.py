"""The check's control and faults: each has to make `correct` false.

The control is the plain reference computed in bfloat16 in the program's
place.  The faults (portbench/faults.py) break the timed path underneath
a whole run: a cycle that returns its iterate unchanged, an answer
altered at one node where it is produced, and a solve that stops after
the FMG start and reports converged.  (A batch and an exchange between
chips, the other faults of the contract, do not exist in these one-card,
one-problem cells.)"""
import pytest

from portbench import faults
from portbench.harness import main, spec
from portbench.tests.conftest import tiny

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    res = main.run_cell(workload, 2 ** 32 + 9, 0.2, False, device="cpu",
                        system="control", config=tiny(workload),
                        traffic=dict(spec.traffic(spec.workload(
                            spec.load_benchmark(), workload)["traffic"]),
                            warmup=1))
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_cycle_that_returns_its_iterate_is_caught(workload):
    with faults.unchanged_cycle():
        res = main.run_cell(workload, 11, 0.2, False, device="cpu",
                            config=tiny(workload))
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_at_one_node_is_caught(workload):
    with faults.altered_answer():
        res = main.run_cell(workload, 12, 0.2, False, device="cpu",
                            config=tiny(workload))
    assert not res["correct"], res["compared"]
    assert res["compared"]["res_max"]["value"] > \
        res["compared"]["res_max"]["limit"]


@pytest.mark.parametrize("workload", [
    w["name"] for w in spec.load_benchmark()["workloads"]
    if spec.traffic(w["traffic"])["entry"] == "solve"])
def test_a_solve_that_stops_after_fmg_is_caught(workload):
    """solve() returns FMG's prolonged iterate, with no finest cycle.  (In
    solve_mgcg the FMG start already holds one finest cycle and reads as
    sound runs do at the cells' size, so it is no fault the check can
    see there.)"""
    with faults.no_cycle_after_fmg():
        res = main.run_cell(workload, 13, 0.2, False, device="cpu",
                            config=tiny(workload))
    assert res["failed"] == 0, "the fault reports converged"
    assert not res["correct"], res["compared"]
    assert res["compared"]["res_rel"]["value"] > \
        res["compared"]["res_rel"]["limit"]
