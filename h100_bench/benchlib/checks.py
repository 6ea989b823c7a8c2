"""What makes a run's result admissible: no JAX in the process, and the
timed path's outputs against the plain reference."""

from __future__ import annotations

import sys

# top-level module names that the process that prints a result may not
# hold; compared whole, since the port's name begins with the JAX
# package's
FORBIDDEN = ("jax", "jaxlib", "flax", "rl_ode_physics_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and each limit's number present and finite."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is not None and value != value:
            value = None                      # NaN: no reading
        passed = value is not None and value <= limit
        ok = ok and passed
        rows.append((name, value, limit))
    return ok, rows


def check(reference, samples, setup, others=()) -> list:
    """The reference module's numbers for ``samples`` (``window.run``):
    each sampled world-call's answers that the configuration allows
    (``reference.answers``), and the program's state after the call
    judged against them (``reference.gaps``), the largest of each number
    over the samples, with ``world_calls`` compared. ``others``: lists of
    states after each sample, aligned with ``samples`` (a control's), each
    judged against the same answers. One dict for the program, then one
    for each of ``others``."""
    import math
    worst = [{} for _ in range(1 + len(others))]
    for n, s in enumerate(samples):
        for j in range(len(s["before"]["pos"])):
            allowed = reference.answers(s["before"], j, setup.cfg,
                                        setup.traffic)
            afters = [s["after"]] + [o[n] for o in others]
            for w, after in zip(worst, afters):
                got = reference.gaps(
                    {k: v[j] for k, v in after.items()}, allowed,
                    {k: v[j] for k, v in s["before"].items()})
                for name, value in got.items():
                    old = w.get(name, 0.0)
                    w[name] = (value if math.isnan(value) or math.isnan(old)
                               else max(old, value))
                w["world_calls"] = w.get("world_calls", 0) + 1
    return worst
