"""The least time a density-matrix run takes on one H100, from the bound
arithmetic of ``portbench/bounds.py`` (imported, not changed).

ρ is a planar (2, 2^n, 2^n) float32 tensor of 4^n entries.  Each window or
pair step of a density plan is one pass over ρ, 16 bytes an entry read and
written, whose operations are both sides' products: 2 × 8·D FLOPs an entry
for a window of D = 2^width (a pair: 2 × 8·(D1 + D2)), at the rate of the
configuration's dot mode.  Diagonal phases and flips add no bytes of their
own (they fold into a pass), and a contraction on k targets is a window of
width k.  So the bound reads the same work whatever kernel, or number of
passes, runs a step: a 128 × 128 tile of both sides fits in shared memory,
so one pass a step is reachable.  The initial state is a fill (8 bytes an
entry), the readout 12 bytes for each of the 2^n diagonal entries.  A step
kind this module does not know raises.
"""
from __future__ import annotations

from portbench import bounds

NO_PASS = ("DiagStep", "PhaseStep", "FlipStep")


def step_bound_s(step, n: int, mode: str) -> float:
    """Seconds a density plan step takes at least on one H100, on an
    ``n``-qubit ρ, by the kind of step (its class name) and its
    geometry."""
    mode = bounds._BOUND_MODE[mode]
    kind = type(step).__name__
    entries = 4 ** n
    nbytes = bounds.STATE_BYTES * entries
    if kind in NO_PASS:
        return 0.0
    if kind in ("WindowStep", "ContractStep"):
        width = step.width if kind == "WindowStep" else len(step.targets)
        d = 2 ** width
        return bounds.product_bound(nbytes, 2 * 8 * d * entries, mode,
                                    d >= 8)[0] / 1e3
    if kind == "PairStep":
        return bounds.pair_bound(nbytes, 2 * entries, 2 ** step.first.width,
                                 2 ** step.second.width, mode)[0] / 1e3
    raise ValueError(f"no density bound for a plan step of kind {kind!r}")


def plan_bound_s(plan, mode: str) -> float:
    """The sum of :func:`step_bound_s` over a plan's steps."""
    return sum(step_bound_s(s, plan.n, mode) for s in plan.steps)


def fill_bound_s(n: int) -> float:
    """A fresh ρ written once (8 bytes an entry)."""
    return bounds.fill_bound_s(2 * n)


def readout_bound_s(n: int) -> float:
    """The diagonal read to the host: 12 bytes an entry."""
    return bounds.bound(12 * 2 ** n)[0] / 1e3
