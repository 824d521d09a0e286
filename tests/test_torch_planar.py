"""The port's planar executor on the CPU vs ``qbot_tpu.tpu.planar`` on
CPU-JAX, on the same plans (the port's compiler, equal to ``qbot_tpu``'s,
paired by default) and the same numpy-seeded states.

Tolerance: 1e-5 absolute on amplitudes and probabilities (float32 state,
up to a few tens of passes, sums taken in another order); 1e-6 for state
preparation and readout, which do no matrix products.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qbot_tpu.tpu import kernels as jk
from qbot_tpu.tpu import planar as jp
from qbot_tpu.tpu.circuit import (
    Circuit,
    grover_circuit,
    parameterized_layers,
    qft_circuit,
    random_circuit,
)
from qbot_tpu.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    PairStep,
    PhaseStep,
    ReflectStep,
    WindowStep,
)
from qbot_tpu_torch.tpu import planar as tp
from qbot_tpu_torch.tpu.compiler import compile_circuit

torch.set_num_threads(1)

TOL = 1e-5


def _rand_state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi /= np.linalg.norm(psi)
    return np.stack([psi.real, psi.imag]).astype(np.float32)


def _rand_unitary(d, rng):
    q, r = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def brickwork(n, layers, seed=0):
    """``bench.py``'s random brickwork: Haar 1-qubit gates, then CX on
    alternating neighbour pairs, per layer."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    for layer in range(layers):
        for q in range(n):
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            qm, r = np.linalg.qr(z)
            c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())), [q])
        for q in range(layer % 2, n - 1, 2):
            c.gate(X, [q + 1], controls=[q])
    return c


@pytest.fixture
def interpret_kernels():
    jk.set_kernel_mode("interpret")
    try:
        yield
    finally:
        jk.set_kernel_mode("auto")


def every_step_kind(n=10, seed=3):
    """A circuit whose 4-wide plan holds every step kind the executor
    runs: windows with fused flips and phases, a reflection, a standalone
    diagonal, phase, flip and a cross-window contraction."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    c.cz(1, 8)                                  # phase fused into a window
    c.phase_flip(77)
    for q in range(n):
        c.h(q)
    c.phase_flip(0)
    for q in range(n):
        c.h(q)                                  # with the above: reflection
    c.gate(_rand_unitary(4, rng), [2, 7])       # contraction
    c.rx(3, 0.3)
    c.diagonal(np.exp(1j * rng.uniform(0, 6, size=8)), [0, 5, 9])
    c.phase_flip(513)
    c.rz(4, 1.1)
    c.cz(0, 9)                                  # standalone phase
    c.phase_flip(12)                            # standalone flip
    return c


CIRCUITS = {
    "random": (lambda: random_circuit(10, 3, seed=2), 7),
    "qft": (lambda: qft_circuit(8), 4),
    "grover": (lambda: grover_circuit(9, 300, iterations=3), 7),
    "every_step": (every_step_kind, 4),
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_apply_plan_matches_jax(name):
    make, window = CIRCUITS[name]
    circ = make()
    plan = compile_circuit(circ, window=window)
    psi = _rand_state(circ.n, 11)
    want = np.asarray(jp.apply_plan_planar(jnp.asarray(psi), plan))
    got = tp.apply_plan_planar(torch.from_numpy(psi), plan)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # the plain twin runs the same steps through the same plain versions
    np.testing.assert_array_equal(
        tp.apply_plan_planar_ref(torch.from_numpy(psi), plan).numpy(),
        got.numpy())


# circuits whose plans hold pairs: trailing pairs (B = 1) at window 7 and 2,
# a middle pair (B = 512, D1 = 2) at window 2 on 12 qubits, and the
# random circuit that ``qbot_tpu`` pairs at window 7
PAIRED = {
    "brickwork_w7": (lambda: brickwork(10, 4), 7),
    "brickwork_w2": (lambda: brickwork(9, 4, seed=1), 2),
    "middle_pair": (lambda: brickwork(12, 3, seed=2), 2),
    "random": (lambda: random_circuit(10, 2, seed=1), 7),
}


@pytest.mark.parametrize("name", list(PAIRED))
def test_pair_step(name, interpret_kernels):
    """Paired plans vs ``qbot_tpu``'s apply_plan_planar with its pair
    kernels in interpret mode, and vs the same circuit unpaired."""
    make, window = PAIRED[name]
    circ = make()
    plan = compile_circuit(circ, window=window)
    assert any(isinstance(s, PairStep) for s in plan.steps)
    psi = _rand_state(circ.n, 12)
    want = np.asarray(jp.apply_plan_planar(jnp.asarray(psi), plan))
    got = tp.apply_plan_planar(torch.from_numpy(psi), plan)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    unpaired = tp.apply_plan_planar(
        torch.from_numpy(psi), compile_circuit(circ, window=window,
                                               pair=False))
    np.testing.assert_allclose(got.numpy(), unpaired.numpy(), atol=TOL)


def test_every_step_kind_is_exercised():
    plan = compile_circuit(every_step_kind(), window=4)
    kinds = {type(s) for s in plan.steps}
    assert {WindowStep, ReflectStep, DiagStep, PhaseStep, FlipStep,
            ContractStep} <= kinds
    win = [s for s in plan.steps if isinstance(s, WindowStep)]
    assert any(s.pre_flips for s in win)
    assert any(s.pre_phases for s in win)


def test_input_state_is_not_written():
    plan = compile_circuit(every_step_kind(), window=4)
    psi = torch.from_numpy(_rand_state(10, 4))
    before = psi.clone()
    tp.apply_plan_planar(psi, plan)
    assert torch.equal(psi, before)


def _grover_body(n, marked):
    c = Circuit(n)
    c.phase_flip(marked)
    for q in range(n):
        c.h(q)
    c.phase_flip(0)
    for q in range(n):
        c.h(q)
    return c


@pytest.mark.parametrize("n,marked", [(10, 345), (11, 2000)])
def test_scanned_reflection_runner_matches_jax(n, marked):
    init = Circuit(n)
    for q in range(n):
        init.h(q)
    body_plan = compile_circuit(_grover_body(n, marked))
    assert [type(s) for s in body_plan.steps] == [ReflectStep]
    init_plan = compile_circuit(init)
    repeats = 8
    want = np.asarray(jp.make_scanned_planar_runner(
        body_plan, repeats, init_plan=init_plan)(jp.zero_state_planar(n)))
    got = tp.make_scanned_planar_runner(body_plan, repeats,
                                        init_plan=init_plan)(
        tp.zero_state_planar(n, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    p = float(tp.planar_probs(got)[marked])
    assert abs(p - np.sin((2 * repeats + 1)
                          * np.arcsin(2 ** (-n / 2))) ** 2) < TOL


def test_scanned_runner_loops_other_bodies():
    circ = random_circuit(8, 2, seed=9)
    plan = compile_circuit(circ)
    want = np.asarray(jp.make_scanned_planar_runner(plan, 3)(
        jp.zero_state_planar(8)))
    got = tp.make_scanned_planar_runner(plan, 3)(tp.zero_state_planar(8,
                                                                      "cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_product_state_matches_jax():
    rng = np.random.default_rng(5)
    kets = [rng.normal(size=d) + 1j * rng.normal(size=d) for d in (2, 4, 8)]
    want = np.asarray(jp.product_state_planar(kets))
    got = tp.product_state_planar(kets, "cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("targets", [None, [0], [3, 1], [0, 2, 5, 6]])
def test_probs_match_jax(targets):
    psi = _rand_state(7, 6)
    want = np.asarray(jp.planar_probs(jnp.asarray(psi), targets, 7))
    got = tp.planar_probs(torch.from_numpy(psi), targets, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert abs(float(tp.planar_norm(torch.from_numpy(psi)))
               - float(jp.planar_norm(jnp.asarray(psi)))) < 1e-6


def test_state_carries_across_packages():
    """A JAX planar state goes through the port and back as numpy."""
    import qbot_tpu_torch

    plan = compile_circuit(random_circuit(9, 2, seed=3))
    start = jp.apply_plan_planar(jp.zero_state_planar(9), plan)
    mid = qbot_tpu_torch.planar_from_numpy(np.asarray(start), "cpu")
    assert mid.dtype == torch.float32 and mid.is_contiguous()
    out = qbot_tpu_torch.planar_to_numpy(tp.apply_plan_planar(mid, plan))
    want = np.asarray(jp.apply_plan_planar(start, plan))
    np.testing.assert_allclose(out, want, atol=TOL)


def test_state_round_trip():
    psi = _rand_state(5, 8)
    c = tp.from_planar(torch.from_numpy(psi))
    np.testing.assert_array_equal(tp.to_planar(c), psi)
    z = tp.zero_state_planar(3, "cpu")
    assert z.shape == (2, 8) and float(z[0, 0]) == 1.0
    assert float(torch.sum(torch.abs(z))) == 1.0


class TestNotPortedYet:
    """What the port does not run yet raises, naming its ROADMAP item."""

    def test_parameterised_gate(self):
        plan = compile_circuit(parameterized_layers(4, 1))
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            tp.apply_plan_planar(tp.zero_state_planar(4, "cpu"), plan)

    def test_renorm_every(self):
        plan = compile_circuit(random_circuit(4, 1))
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            tp.make_scanned_planar_runner(plan, 4, renorm_every=2)
