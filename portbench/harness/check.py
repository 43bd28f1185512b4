"""The comparison that decides `correct`.

The reference (the configuration's "reference" module) works the
problem out again from the run's data and judges what the system
produced: the finest level's b, g and operator as built, and each checked
request's u by its residual in the mass norm, relative to the zero
iterate's, and by its largest nodal residual, relative to the zero
iterate's (which a wrong value at a few nodes moves where the mass
norm, which weighs a node by h^3, does not).  The limits are the
configuration's ("check" in its file).
"""
from __future__ import annotations

from . import spec
from .systems import reference_problem


def judge(config: dict, finest, finest_coef, answers, failed: int,
          seed: int, device):
    """(correct, compared): compared maps each number's name to its value
    and limit; answers are (coef, u) pairs."""
    ref = spec.reference(config["reference"])
    limits = config["check"]
    p = reference_problem(config, finest_coef)
    z = ref.probe_vector(p, seed, device)
    errs = ref.problem_errors(p, finest.b, finest.g, finest.apply_op, z)
    del z
    res, rmax = [], []
    for coef, u in answers:
        rs, r0, m, m0 = ref.residual_norms(reference_problem(config, coef),
                                           u.to(device))
        res.append(rs / r0)
        rmax.append(m / m0)
    compared = {
        "res_rel": {"value": max(res) if res else float("nan"),
                    "limit": limits["res_rel"]},
        "res_max": {"value": max(rmax) if rmax else float("nan"),
                    "limit": limits["res_max"]},
        "problem_rel": {"value": max(errs.values()),
                        "limit": limits["problem_rel"]},
        "failed": {"value": failed, "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    return correct, compared
