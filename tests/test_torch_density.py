"""The port's planar density-matrix executor on the CPU vs ``qbot_tpu``'s
(its Pallas kernels in interpret mode) and vs the complex-dtype density
executor ``qbot_tpu.tpu.simulator.apply_plan_density``, on the same plans
and numpy-seeded inputs.

Tolerance: 1e-5 absolute on the entries of ρ and on probabilities (float32
density matrices of at most 9 qubits, each step a window or pair pass on
the rows and one on the columns, sums taken in another order); 1e-4
against the complex executor, as ``tests/test_planar.py`` holds
``qbot_tpu``'s planar density executor to it.

Then the port alone: the product initial state, the runner's spans and
pass counter, and the density path held to the benchmark's plain
complex128 reference (``portbench/reference/density.py``), which also
catches a wrong column side.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_density_cases as dc
import qbot_tpu_torch
from _torch_parity import both, brickwork
from qbot_tpu.tpu import compiler as jc
from qbot_tpu.tpu import kernels as jk
from qbot_tpu.tpu import planar as jp
from qbot_tpu.tpu.simulator import apply_plan_density
from qbot_tpu_torch.tpu import circuit as tcirc
from qbot_tpu_torch.tpu import kernels as tk
from qbot_tpu_torch.tpu import planar as tp
from qbot_tpu_torch.tpu.compiler import (
    FlipStep,
    PairStep,
    compile_circuit,
    expand_phases,
    expand_reflections,
)
from qbot_tpu_torch.utils import profiling

torch.set_num_threads(1)

TOL = 1e-5
COMPLEX_TOL = 1e-4


@pytest.fixture
def interpret_kernels():
    jk.set_kernel_mode("interpret")
    try:
        yield
    finally:
        jk.set_kernel_mode("auto")


def bell(m):
    c = m.Circuit(2)
    c.h(0)
    c.cx(0, 1)
    return c


def flips_and_diagonal(m):
    c = m.Circuit(4)
    for q in range(4):
        c.h(q)
    c.phase_flip(9)
    for q in range(4):
        c.h(q)
    c.diagonal(np.exp(1j * np.linspace(0, 1, 4)), [1, 3])
    return c


def flips_and_phases(m, n):
    """A plan whose windows (at 6 qubits, window 3) or pairs (at 8 qubits,
    window 1) carry fused flips and phases, then a reflection, which the
    density executor expands into windows and standalone flips."""
    c = m.Circuit(n)
    for q in range(n):
        c.h(q)
    c.phase_flip(5)
    c.cz(0, n - 1)
    for q in range(n):
        c.rx(q, 0.3 + 0.1 * q)
    c.phase_flip(33)
    for q in range(n):
        c.h(q)
    c.phase_flip(0)
    for q in range(n):
        c.h(q)
    return c


# (circuit, window): tests/test_planar.py:103-140, the 9-qubit brickwork
# whose (0,2)+(2,7) pairs take the middle pair on the rows of the 18-qubit
# view (B = 2^9, D1 = 4) and the trailing pair on the columns (B = 1), and
# windows and pairs with fused flips
CASES = {
    "bell": (bell, 7),
    "random": (lambda m: m.random_circuit(5, 3, seed=11), 3),
    "flips_and_diagonal": (flips_and_diagonal, 2),
    "brickwork": (lambda m: brickwork(m, 9, 4, seed=3), 2),
    "flips_in_window": (lambda m: flips_and_phases(m, 6), 3),
    "flips_on_pairs": (lambda m: flips_and_phases(m, 8), 1),
}


def _rand_density(n, seed):
    """A random mixed state: a convex mix of three pure states."""
    rng = np.random.default_rng(seed)
    rho = np.zeros((2**n, 2**n), np.complex128)
    for p in (0.5, 0.3, 0.2):
        v = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
        v /= np.linalg.norm(v)
        rho += p * np.outer(v, v.conj())
    return rho


def _planar(rho):
    return np.stack([rho.real, rho.imag]).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_density_matches_jax(name, interpret_kernels):
    make, window = CASES[name]
    circ, jcirc = both(make)
    plan = compile_circuit(circ, window=window)
    jplan = jc.compile_circuit(jcirc, window=window)
    rho = _rand_density(circ.n, 5)
    want_planar = np.asarray(jp.apply_plan_density_planar(
        jnp.asarray(_planar(rho)), jplan))
    want_complex = np.asarray(apply_plan_density(jnp.asarray(rho), jplan))
    got = tp.apply_plan_density_planar(torch.from_numpy(_planar(rho)), plan)
    np.testing.assert_allclose(got.numpy(), want_planar, atol=TOL)
    g = got.numpy()
    np.testing.assert_allclose(g[0] + 1j * g[1], want_complex,
                               atol=COMPLEX_TOL)
    # the plain twin runs the same steps through the same plain versions
    np.testing.assert_array_equal(
        tp.apply_plan_density_planar_ref(torch.from_numpy(_planar(rho)),
                                         plan).numpy(), g)


def test_brickwork_pairs_take_both_kernels():
    """The rows of the 18-qubit view take the middle pair kernel, the
    columns the trailing one."""
    plan = compile_circuit(brickwork(tcirc, 9, 4, seed=3), window=2)
    pairs = [s for s in plan.steps if isinstance(s, PairStep)]
    assert [(s.first.start, s.first.width, s.second.width)
            for s in pairs] == [(0, 2, 7)] * 2
    assert tk.pair_route(18, 0, 2, 7) == "middle"
    assert tk.pair_route(18, 9, 2, 7) == "trailing"


@pytest.mark.parametrize("window", [2, 7])
def test_zero_state_density_is_pure_state(window):
    """From |0⟩⟨0|, ρ = ψψ† of the statevector executor's ψ."""
    circ = brickwork(tcirc, 6, 3, seed=9)
    plan = compile_circuit(circ, window=window)
    rho = tp.apply_plan_density_planar(tp.zero_density_planar(6, "cpu"),
                                       plan)
    psi = tp.from_planar(tp.apply_plan_planar(tp.zero_state_planar(6, "cpu"),
                                              plan))
    r = rho.numpy()
    np.testing.assert_allclose(r[0] + 1j * r[1], np.outer(psi, psi.conj()),
                               atol=TOL)
    assert abs(float(torch.sum(torch.diagonal(rho[0]))) - 1.0) < TOL


def test_runner_matches_apply_and_keeps_input():
    plan = compile_circuit(flips_and_phases(tcirc, 6), window=3)
    run = tp.make_planar_density_runner(plan)
    rho = torch.from_numpy(_planar(_rand_density(6, 8)))
    before = rho.clone()
    once = run(rho)
    np.testing.assert_array_equal(
        once.numpy(), tp.apply_plan_density_planar(rho, plan).numpy())
    np.testing.assert_array_equal(run(rho).numpy(), once.numpy())
    assert torch.equal(rho, before)


def test_zero_density_matches_jax():
    got = tp.zero_density_planar(3, "cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp.zero_density_planar(3)))


@pytest.mark.parametrize("targets", [None, [0, 1], [2], [3, 0]])
def test_density_probs_match_jax(targets):
    def circuit(m):
        c = m.Circuit(4)
        c.h(0)
        c.cx(0, 1)
        c.ry(3, 0.8)
        return c

    c, jcirc = both(circuit)
    plan = compile_circuit(c)
    rho = tp.apply_plan_density_planar(tp.zero_density_planar(4, "cpu"),
                                       plan)
    want = np.asarray(jp.planar_density_probs(
        jp.apply_plan_density_planar(jp.zero_density_planar(4),
                                     jc.compile_circuit(jcirc)),
        targets))
    got = tp.planar_density_probs(rho, targets)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    if targets == [0, 1]:
        np.testing.assert_allclose(got.numpy(), [0.5, 0, 0, 0.5], atol=TOL)


def test_density_state_carries_across_packages():
    """A JAX density matrix goes through the port and back as numpy."""
    circ, jcirc = both(lambda m: m.random_circuit(5, 2, seed=3))
    plan = compile_circuit(circ, window=3)
    jplan = jc.compile_circuit(jcirc, window=3)
    start = jp.apply_plan_density_planar(jp.zero_density_planar(5), jplan)
    mid = qbot_tpu_torch.planar_from_numpy(np.asarray(start), "cpu")
    assert mid.shape == (2, 32, 32) and mid.dtype == torch.float32
    out = qbot_tpu_torch.planar_to_numpy(tp.apply_plan_density_planar(mid,
                                                                      plan))
    want = np.asarray(jp.apply_plan_density_planar(start, jplan))
    np.testing.assert_allclose(out, want, atol=TOL)


def test_parameterised_density_matches_reference():
    """A parameterised window and a parameterised gate across windows (a
    ContractStep) on the rows and, conjugated, on the columns."""
    def make(m):
        xp = torch if m.__name__.startswith("qbot_tpu_torch") else jnp
        c = m.Circuit(8)
        c.h(0)
        c.param_gate(lambda t: m.g.rot_planar("y", t, xp=xp), [0])
        c.param_gate(lambda t: m.g.rot_planar("x", t, xp=xp), [7],
                     controls=[0])
        c.cx(0, 2)
        return c

    circ, jcirc = both(make)
    plan = compile_circuit(circ, window=3)
    assert any(type(s).__name__ == "ContractStep" for s in plan.steps)
    theta = np.array([0.9, -0.6], np.float32)
    got = tp.apply_plan_density_planar(tp.zero_density_planar(8, "cpu"),
                                       plan, torch.from_numpy(theta))
    want = jp.apply_plan_density_planar(jp.zero_density_planar(8),
                                        jc.compile_circuit(jcirc, window=3),
                                        jnp.asarray(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


# ---------------------------------------------------------------------------
# the product initial state, the repeated runner, its spans and counters,
# and the density path against the benchmark's plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 7))
def test_product_density_matches_kron(n):
    """ρ_0 ⊗ … ⊗ ρ_{n−1}, qubit 0 the most significant bit; one upload."""
    factors = dc.hermitian_factors(n, n)
    want = np.ones((1, 1), np.complex128)
    for f in factors:
        want = np.kron(want, f)
    before = profiling.counters().get("h2d_bytes", 0)
    got = tp.product_density_planar(factors, "cpu")
    assert got.shape == (2, 2**n, 2**n) and got.dtype == torch.float32
    # float32 products of n float32 factors
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), want,
                               atol=1e-6)
    assert profiling.counters()["h2d_bytes"] - before == 4 * 8 * n


def _thermal_brickwork(n, layers, seed):
    from portbench.entries.statevector import to_circuit
    from portbench.families.brickwork import brickwork_ops
    from portbench.families.thermal_brickwork import thermal_factors

    ops = brickwork_ops(n, layers, seed)
    return ops, to_circuit(n, ops), thermal_factors(n, seed)


def _bodies(plan, rho, repeats):
    """The plan's runner called ``repeats`` times, as the benchmark's
    density entry calls it."""
    run = tp.make_planar_density_runner(plan)
    for _ in range(repeats):
        rho = run(rho)
    return rho


@pytest.mark.parametrize("n", [1, 5])
def test_zero_factors_give_the_zero_density(n):
    """n factors |0⟩⟨0| build ``zero_density_planar``'s state bit for
    bit."""
    got = tp.product_density_planar([np.diag([1.0, 0.0])] * n, "cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  tp.zero_density_planar(n, "cpu").numpy())


# relative Frobenius and readout limits against the complex128 reference:
# float32 ρ of at most 8 qubits through 6 bodies of row and column passes
# (sums of up to 128 float32 products each), readings 2-8e-7
REF_TOL = 1e-5


@pytest.mark.parametrize("n", [5, 6, 8])
def test_density_path_matches_the_plain_reference(n):
    """Seeded thermal factors and Haar brickwork, 2 layers × 3 bodies,
    through the kernels' plain versions (window 7: one window at 5-6
    qubits, (1, 7) pairs and a diagonal at 8)."""
    from portbench.families.thermal_brickwork import ThermalRequest
    from portbench.reference import density

    ops, circ, factors = _thermal_brickwork(n, 2, 40 + n)
    plan = compile_circuit(circ, window=7)
    got = _bodies(plan, tp.product_density_planar(factors, "cpu"), 3)
    req = ThermalRequest("circuit", n, 0, body_ops=ops, repeats=3,
                         rhos=factors)
    readings = density.judge(req, {"state": got, "readouts": [
        tp.planar_density_probs(got)]}, "cpu")
    assert max(readings.values()) <= REF_TOL, readings


def _cell_limits():
    import json
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "portbench" / "limits"
            / "dm13-brickwork.json")
    return json.loads(path.read_text())


def _column_side(monkeypatch, make):
    """``_density_tables`` with its column matrix replaced by
    ``make(W)``."""
    tables = tp._density_tables

    def patched(step, device):
        both = tables(step, device)

        def pair(params):
            w, _ = both(params)
            return w, make(w)
        return pair
    monkeypatch.setattr(tp, "_density_tables", patched)


@pytest.mark.parametrize("fault", ["unconjugated", "skipped"])
def test_reference_catches_a_wrong_column_side(monkeypatch, fault):
    """A column side run with W in place of conj(W), or left out (the
    identity), fails the cell's limits by far."""
    from portbench.families.thermal_brickwork import ThermalRequest
    from portbench.reference import density

    n = 8
    ops, circ, factors = _thermal_brickwork(n, 2, 7)
    plan = compile_circuit(circ, window=7)
    if fault == "unconjugated":
        _column_side(monkeypatch, lambda w: w)
    else:
        _column_side(monkeypatch, lambda w: torch.stack(
            [torch.eye(w.shape[-1]), torch.zeros(w.shape[1:])]))
    got = _bodies(plan, tp.product_density_planar(factors, "cpu"), 3)
    req = ThermalRequest("circuit", n, 0, body_ops=ops, repeats=3,
                         rhos=factors)
    readings = density.judge(req, {"state": got, "readouts": [
        tp.planar_density_probs(got)]}, "cpu")
    limits = _cell_limits()
    assert readings["state_gap"] > 100 * limits["state_gap"], readings
    assert readings["hermitian_gap"] > 100 * limits["hermitian_gap"], \
        readings


def test_runner_spans_and_diag_pass_counts():
    """Under ``profiling.tracing()`` the runner records
    ``qbot.plan.prepare`` (its first build) and ``qbot.plan.apply`` (each
    call).  Each call counts ``density_diag_passes``, two elementwise
    passes over ρ per standalone diagonal (0 for the thermal brickwork,
    whose diagonals are all fused phases, and still counted), and
    ``density_fused_phases``, the phases handed to the row launches, rows
    and columns apart."""
    from qbot_tpu_torch.tpu.compiler import DiagStep, PhaseStep

    _, circ, factors = _thermal_brickwork(8, 4, 5)
    plan = compile_circuit(circ, window=7)
    diags = sum(isinstance(s, DiagStep)
                for s in expand_phases(expand_reflections(plan.steps)))
    phases = sum(len(w.pre_phases) for w in dc.fused_windows(plan.steps))
    # every diagonal the reference's executor passes over ρ is a fused phase
    assert diags and phases == diags
    rho = tp.product_density_planar(factors, "cpu")
    profiling.reset_spans()
    with profiling.tracing():
        _bodies(plan, rho, 3)
    spans = profiling.span_totals()
    assert spans["qbot.plan.prepare"]["calls"] == 1
    assert spans["qbot.plan.apply"]["calls"] == 3
    counts = profiling.span_counts()
    assert counts["density_diag_passes"] == 0
    assert counts["density_fused_phases"] == 2 * 3 * phases

    # a standalone DiagStep and a standalone PhaseStep: two passes each
    def standalone(m):
        c = m.Circuit(9)
        for q in range(9):
            c.h(q)
        c.diagonal(np.exp(1j * np.linspace(0, 1, 4)), [1, 5])
        for q in range(9):
            c.h(q)
        c.gate(dc.S, [5], [1])
        return c

    plan = compile_circuit(standalone(tcirc), window=2)
    assert [type(s) for s in plan.steps][-3:] == [DiagStep, PairStep,
                                                  PhaseStep]
    profiling.reset_spans()
    with profiling.tracing():
        _bodies(plan, tp.zero_density_planar(9, "cpu"), 3)
    counts = profiling.span_counts()
    assert counts["density_diag_passes"] == 2 * 3 * 2
    assert counts["density_fused_phases"] == 0


@pytest.mark.parametrize("name", list(dc.CASES))
def test_fused_phases_on_both_sides(name, interpret_kernels):
    """Phases fused into a window's or pair's row launch, on the rows and,
    conjugated, on the columns: the runner against the benchmark's
    complex128 U ρ U† gate by gate and against ``qbot_tpu``'s density
    executor, which runs each fused phase as two diagonal passes."""
    from portbench.families.thermal_brickwork import ThermalRequest
    from portbench.reference import density

    n = 9
    make, window = dc.CASES[name]
    ops = make(n, np.random.default_rng(7))
    circ, jcirc = both(lambda m: dc.circuit(m, n, ops))
    plan = compile_circuit(circ, window=window)
    assert dc.engages(name, plan)
    factors = dc.hermitian_factors(n, 12)
    got = tp.make_planar_density_runner(plan)(
        tp.product_density_planar(factors, "cpu"))
    req = ThermalRequest("circuit", n, 0, body_ops=ops, repeats=1,
                         rhos=factors)
    readings = density.judge(req, {"state": got, "readouts": [
        tp.planar_density_probs(got)]}, "cpu")
    assert max(readings.values()) <= REF_TOL, readings
    rho = tp.product_density_planar(factors, "cpu").numpy()
    want = jp.apply_plan_density_planar(
        jnp.asarray(rho), jc.compile_circuit(jcirc, window=window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_flip_plan_from_a_mixed_state():
    """Standalone flips and fused phases (a reflection's) on a mixed
    product state: the runner against the plain versions."""
    plan = compile_circuit(flips_and_phases(tcirc, 8), window=1)
    assert any(isinstance(s, FlipStep)
               for s in expand_phases(expand_reflections(plan.steps)))
    rho = tp.product_density_planar(dc.hermitian_factors(8, 11), "cpu")
    got = tp.make_planar_density_runner(plan)(rho)
    want = tp.apply_plan_density_planar_ref(rho, plan)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
