"""``window="auto"`` of the port's compiler against ``qbot_tpu``'s.

The port ranks the reference's candidates in the reference's order
(``qbot_tpu/tpu/compiler.py:474-495``: for each width 4..8 the dot
engine's plan, ``partition="dot"``, then up to width 7 the kernel
engine's, its ``"pallas"`` entries) by the card's cost models: the list
must equal the reference's entry by entry, engine by engine, each plan
field by field, and ``compile_circuit(c, "auto")`` be the first cheapest
of them, its ``engine`` set.  The reference lists its ``"pallas"``
candidates only while its kernels are on, so its list is taken under
``set_kernel_mode("interpret")``.  ``run_lowered(lp, window="auto")``
readouts hold to ``qbot_tpu``'s within 1e-5 (float32 states; the two
packages may pick different widths, whose float32 roundings differ).

Tolerance: none on plans (bit-identical matrices and factors); 1e-5 on
outcome probabilities.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import ENGINES, assert_same, both, brickwork, grover_body
from qbot_tpu.frontend import lowering as jl
from qbot_tpu.tpu import compiler as jc
from qbot_tpu.tpu import kernels as jk
from qbot_tpu_torch import lower_program, run_lowered
from qbot_tpu_torch.tpu import circuit as tcirc
from qbot_tpu_torch.tpu import compiler as tc
from qbot_tpu_torch.tpu import kernels as tk
from qbot_tpu_torch.tpu import dotplan as td
from qbot_tpu_torch.tpu.compiler import (
    AUTO_WIDTHS,
    DOT_WIDTHS,
    auto_candidates,
    compile_circuit,
    dot_cost_model,
    dot_step_costs,
    dot_step_launches,
    launch_seconds,
    plan_cost_model,
    step_costs,
    step_launches,
)

torch.set_num_threads(1)

TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
MODES = ("f32", "f32_mix", "bf16_3x", "bf16")

CIRCUITS = {
    "brickwork": lambda m: brickwork(m, 12, 4),
    "brickwork_9": lambda m: brickwork(m, 9, 3, seed=2),
    "grover_body": lambda m: grover_body(m, 11, 1234),
    "ansatz": lambda m: m.parameterized_layers(10, 3),
}


@pytest.fixture
def reference_kernels_on():
    """``qbot_tpu`` lists its kernel candidates only with its kernels on."""
    jk.set_kernel_mode("interpret")
    try:
        yield
    finally:
        jk.set_kernel_mode("auto")


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_candidates_are_the_reference_kernel_candidates(
        name, pair, reference_kernels_on):
    """The kernel engine's entries: the reference's ``"pallas"`` plans at
    widths 4..7, each costed by ``plan_cost_model``."""
    circ, jcirc = both(CIRCUITS[name])
    got = [c for c in auto_candidates(circ, pair) if c[2] == "kernel"]
    want = [p for _, p, eng in jc.auto_candidates(jcirc, pair, mode="f32")
            if eng == "pallas"]
    assert len(got) == len(want) == len(AUTO_WIDTHS)
    for w, (cost, plan, _), ref in zip(AUTO_WIDTHS, got, want):
        assert plan.window == ref.window == min(w, circ.n)
        assert_same(plan, ref, f"width {w}")
        assert cost == plan_cost_model(plan, tk.dot_mode())


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_candidates_are_the_reference_list(name, pair,
                                           reference_kernels_on):
    """The whole list, in the reference's order, engine by engine: the dot
    plans (``partition="dot"``) costed by ``dot_cost_model``, the kernel
    plans by ``plan_cost_model``."""
    circ, jcirc = both(CIRCUITS[name])
    got = auto_candidates(circ, pair)
    want = jc.auto_candidates(jcirc, pair, mode="f32")
    assert [ENGINES[e] for _, _, e in got] == [e for _, _, e in want]
    assert [e for _, _, e in got] == [
        e for w in DOT_WIDTHS
        for e in (("dot", "kernel") if w in AUTO_WIDTHS else ("dot",))]
    for i, ((cost, plan, engine), (_, ref, _)) in enumerate(zip(got, want)):
        assert_same(plan, ref, f"candidate {i}")
        model = dot_cost_model if engine == "dot" else plan_cost_model
        assert cost == model(plan, tk.dot_mode())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_auto_is_the_first_argmin(name, pair, mode):
    circ, jcirc = both(CIRCUITS[name])
    tk.set_dot_mode(mode)
    try:
        candidates = auto_candidates(circ, pair)
        got = compile_circuit(circ, "auto", pair)
    finally:
        tk.set_dot_mode("f32")
    costs = [c for c, _, _ in candidates]
    _, best, engine = candidates[costs.index(min(costs))]
    assert got.engine == engine
    assert got.window == best.window
    partition = {"dot": "dot", "kernel": "pallas"}[engine]
    want = jc.compile_circuit(jcirc, best.window, pair, partition=partition)
    want.engine = ENGINES[engine]
    assert_same(got, want)
    assert got.num_passes == best.num_passes


def test_ties_go_to_the_first_width(monkeypatch):
    """Widths that clamp at small n stay as duplicates of equal cost, and
    ``min`` keeps the first of equal costs, as the reference's does: a dot
    candidate before the kernel candidate of its width."""
    circ = brickwork(tcirc, 6, 3)
    candidates = auto_candidates(circ)
    for engine in ("dot", "kernel"):
        assert len({c for c, _, e in candidates if e == engine}) == 1
    got = compile_circuit(circ, "auto")
    assert got.window == AUTO_WIDTHS[0]
    assert got.engine == min(candidates, key=lambda c: c[0])[2]
    kernel = iter([3.0, 1.0, 1.0, 2.0])
    dot = iter([3.0, 3.0, 2.0, 3.0, 3.0])
    monkeypatch.setattr(tc, "plan_cost_model", lambda plan, mode: next(kernel))
    monkeypatch.setattr(tc, "dot_cost_model", lambda plan, mode: next(dot))
    got = compile_circuit(circ, "auto")
    assert (got.engine, got.window) == ("kernel", 5)
    monkeypatch.setattr(tc, "plan_cost_model", lambda plan, mode: 1.0)
    monkeypatch.setattr(tc, "dot_cost_model", lambda plan, mode: 1.0)
    got = compile_circuit(circ, "auto")
    assert (got.engine, got.window) == ("dot", DOT_WIDTHS[0])


def test_dot_pick_that_does_not_lower_reranks_the_kernels(monkeypatch):
    """The reference's ``"auto_pallas"``: a dot pick that the dot engine
    cannot lower gives way to the first cheapest kernel candidate, never a
    dot-partition plan on the kernel engine."""
    circ = brickwork(tcirc, 12, 4)
    monkeypatch.setattr(tc, "dot_cost_model", lambda plan, mode: 0.0)
    assert compile_circuit(circ, "auto").engine == "dot"
    monkeypatch.setattr(td, "lower_dot_plan", lambda plan: None)
    got = compile_circuit(circ, "auto")
    kernel = min((c for c in auto_candidates(circ) if c[2] == "kernel"),
                 key=lambda c: c[0])[1]
    assert (got.engine, got.window, got.num_passes) == (
        "kernel", kernel.window, kernel.num_passes)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("window", range(1, 8))
def test_cost_model_sums_its_steps(window, mode):
    circ = brickwork(tcirc, 12, 4)
    for pair in (True, False):
        plan = compile_circuit(circ, window, pair)
        costs = step_costs(plan, mode)
        assert len(costs) == len(plan.steps)
        assert all(c > 0 for c in costs)
        assert plan_cost_model(plan, mode) == sum(costs)
        assert plan_cost_model(plan, mode) == plan_cost_model(plan, mode)
        if mode == "f32_mix":
            assert costs == step_costs(plan, "f32")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("window", DOT_WIDTHS)
def test_dot_cost_model_sums_its_launches(window, mode):
    """Each step's modelled seconds on the dot engine are its launches',
    a window's in the mode its width runs (f32_mix's rule), and the plan's
    their sum."""
    for circ in (brickwork(tcirc, 12, 4), grover_body(tcirc, 12, 5),
                 tcirc.parameterized_layers(14, 2)):
        plan = compile_circuit(circ, window, partition="dot")
        costs = dot_step_costs(plan, mode)
        assert len(costs) == len(plan.steps)
        assert dot_cost_model(plan, mode) == sum(costs)
        for step, cost in zip(plan.steps, costs):
            want = sum(launch_seconds(x, td.window_mode(mode, x.widths[0])
                                      if x.family.startswith("dot_window")
                                      else mode)
                       for x in dot_step_launches(step, plan.n))
            assert cost == want > 0


@pytest.mark.parametrize("n", [8, 12, 14])
@pytest.mark.parametrize("window", DOT_WIDTHS)
def test_dot_launches_follow_the_engine(n, window):
    """A window (a pair's two) launches a pass for its flips, one for each
    phase, real or complex, and its library product by route; any other
    step what the kernel engine launches for it."""
    for circ in (brickwork(tcirc, n, 4), grover_body(tcirc, n, 5)):
        for step in compile_circuit(circ, window, partition="dot").steps:
            launches = dot_step_launches(step, n)
            kind = type(step).__name__
            if kind not in ("WindowStep", "PairStep"):
                assert launches == step_launches(step, n)
                continue
            wins = ([step] if kind == "WindowStep"
                    else [step.first, step.second])
            want = []
            for w in wins:
                want += ["torch_flip"] if w.pre_flips else []
                want += ["dot_phase_real" if td.phase_is_real(z)
                         else "dot_phase_complex" for _, z, _ in w.pre_phases]
                want.append("dot_window_" + (
                    "first" if w.start == 0 else "trailing"
                    if w.start + w.width == n else "middle"))
            assert [x.family for x in launches] == want
            for x in launches:
                assert x.family in tc.COSTS


@pytest.mark.parametrize("n", [8, 9, 12])
@pytest.mark.parametrize("window", range(1, 8))
def test_launches_follow_the_kernels_routes(n, window):
    """Each step's launches are the wrappers' routes: a window by D, a pair
    by ``pair_route`` and its widths, a reflection as its two kernels."""
    for circ in (brickwork(tcirc, n, 4), grover_body(tcirc, n, 5)):
        for step in compile_circuit(circ, window).steps:
            launches = step_launches(step, n)
            kind = type(step).__name__
            if kind == "WindowStep":
                [x] = launches
                assert x.family == ("window_stream" if step.width <= 2
                                    else "window_tc")
                assert x.phases == len(step.pre_phases)
            elif kind == "PairStep":
                a, b = step.first, step.second
                route = tk.pair_route(n, a.start, a.width, b.width)
                families = [x.family for x in launches]
                if route == "two_windows":
                    assert len(families) == 2
                    assert launches[1].phases == 0
                elif a.width <= 2 and b.width <= 2:
                    assert families == ["pair_stream"]
                elif a.width <= 2:
                    assert families == ["pair_narrow"]
                else:
                    assert families == [f"pair_tc_{route}"]
                assert launches[0].phases == len(a.pre_phases)
                assert sum(x.ops for x in launches) == \
                    8 * (2**a.width + 2**b.width) * 2**n
            elif kind == "ReflectStep":
                assert [x.family for x in launches] == ["reflect_dot",
                                                        "reflect_update"]
                assert launches[0].nbytes == 8 * 2**n
            for x in launches:
                assert x.family in tc.COSTS


def test_wide_d1_narrow_d2_pair_costs_as_its_two_windows():
    """An explicit dot-partition plan on the kernel engine holds a pair of
    D1 >= 8 with D2 <= 4 (the brickwork at 17 qubits, width 3: (0, 3) +
    (3, 1), B = 2^13); its launches are its two windows', the fused
    phases on the first (the second carries none)."""
    n = 17
    plan = compile_circuit(brickwork(tcirc, n, 2), 3, partition="dot")
    assert plan.engine == "kernel"
    pairs = [s for s in plan.steps if isinstance(s, tc.PairStep)
             and s.first.width >= 3 and s.second.width <= 2]
    assert pairs
    for step in pairs:
        want = step_launches(step.first, n) + step_launches(step.second, n)
        assert step_launches(step, n) == want
        assert [x.family for x in want] == ["window_tc", "window_stream"]


@pytest.mark.parametrize("window", ["fast", "auto_pallas", 7.0, None])
def test_unknown_window_raises(window):
    circ = brickwork(tcirc, 6, 2)
    with pytest.raises(ValueError, match="'auto'"):
        compile_circuit(circ, window)


@pytest.mark.parametrize("partition", ["pallas", "sub", None])
def test_unknown_partition_raises(partition):
    circ = brickwork(tcirc, 6, 2)
    with pytest.raises(ValueError, match="'dot'"):
        compile_circuit(circ, 4, partition=partition)


@pytest.mark.parametrize("width", range(1, 8))
def test_integer_widths_unchanged(width):
    circ, jcirc = both(lambda m: brickwork(m, 11, 3, seed=4))
    assert_same(compile_circuit(circ, width),
                jc.compile_circuit(jcirc, width))


BELL = ("qset tensorProd(comp[0], comp[1], comp[0])\n"
        "gate hadamardGate ; 0\ngate pauliXGate ; 2 ; 0\n"
        "meas out ; bell ; [0, 2]")


def _readout(lower, run, src):
    """The outcome probabilities of a program, or what it raised."""
    try:
        probs, _ = run(lower(src))
    except Exception as e:                  # outside the --compile fragment
        return e
    return probs


@pytest.mark.parametrize(
    "name", sorted(p.name for p in (ROOT / "examples").glob("*.qb"))
    + ["bell_basis"])
def test_run_lowered_auto_matches_reference(name):
    """Every example: the readouts of both packages' ``run_lowered(lp,
    window="auto")``, or the same error where the program leaves the
    ``--compile`` fragment."""
    src = BELL if name == "bell_basis" else \
        (ROOT / "examples" / name).read_text()
    want = _readout(jl.lower_program,
                    lambda lp: jl.run_lowered(lp, window="auto"), src)
    got = _readout(lower_program, lambda lp: run_lowered(
        lp, window="auto", device="cpu"), src)
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
