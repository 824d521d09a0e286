"""The port's planar density-matrix executor on the CPU vs ``qbot_tpu``'s
(its Pallas kernels in interpret mode) and vs the complex-dtype density
executor ``qbot_tpu.tpu.simulator.apply_plan_density``, on the same plans
and numpy-seeded inputs.

Tolerance: 1e-5 absolute on the entries of ρ and on probabilities (float32
density matrices of at most 9 qubits, each step a window or pair pass on
the rows and one on the columns, sums taken in another order); 1e-4
against the complex executor, as ``tests/test_planar.py`` holds
``qbot_tpu``'s planar density executor to it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qbot_tpu_torch
from qbot_tpu.tpu import kernels as jk
from qbot_tpu.tpu import planar as jp
from qbot_tpu.tpu.circuit import Circuit, random_circuit
from qbot_tpu.tpu.compiler import PairStep
from qbot_tpu.tpu.simulator import apply_plan_density
from qbot_tpu_torch.tpu import kernels as tk
from qbot_tpu_torch.tpu import planar as tp
from qbot_tpu_torch.tpu.compiler import compile_circuit

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


def bell():
    c = Circuit(2)
    c.h(0)
    c.cx(0, 1)
    return c


def flips_and_diagonal():
    c = Circuit(4)
    for q in range(4):
        c.h(q)
    c.phase_flip(9)
    for q in range(4):
        c.h(q)
    c.diagonal(np.exp(1j * np.linspace(0, 1, 4)), [1, 3])
    return c


def flips_and_phases(n):
    """A plan whose windows (at 6 qubits, window 3) or pairs (at 8 qubits,
    window 1) carry fused flips and phases, then a reflection, which the
    density executor expands into windows and standalone flips."""
    c = Circuit(n)
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
    "random": (lambda: random_circuit(5, 3, seed=11), 3),
    "flips_and_diagonal": (flips_and_diagonal, 2),
    "brickwork": (lambda: brickwork(9, 4, seed=3), 2),
    "flips_in_window": (lambda: flips_and_phases(6), 3),
    "flips_on_pairs": (lambda: flips_and_phases(8), 1),
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
    circ = make()
    plan = compile_circuit(circ, window=window)
    rho = _rand_density(circ.n, 5)
    want_planar = np.asarray(jp.apply_plan_density_planar(
        jnp.asarray(_planar(rho)), plan))
    want_complex = np.asarray(apply_plan_density(jnp.asarray(rho), plan))
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
    plan = compile_circuit(brickwork(9, 4, seed=3), window=2)
    pairs = [s for s in plan.steps if isinstance(s, PairStep)]
    assert [(s.first.start, s.first.width, s.second.width)
            for s in pairs] == [(0, 2, 7)] * 2
    assert tk.pair_route(18, 0, 2, 7) == "middle"
    assert tk.pair_route(18, 9, 2, 7) == "trailing"


@pytest.mark.parametrize("window", [2, 7])
def test_zero_state_density_is_pure_state(window):
    """From |0⟩⟨0|, ρ = ψψ† of the statevector executor's ψ."""
    circ = brickwork(6, 3, seed=9)
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
    plan = compile_circuit(flips_and_phases(6), window=3)
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
    c = Circuit(4)
    c.h(0)
    c.cx(0, 1)
    c.ry(3, 0.8)
    plan = compile_circuit(c)
    rho = tp.apply_plan_density_planar(tp.zero_density_planar(4, "cpu"),
                                       plan)
    want = np.asarray(jp.planar_density_probs(
        jp.apply_plan_density_planar(jp.zero_density_planar(4), plan),
        targets))
    got = tp.planar_density_probs(rho, targets)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    if targets == [0, 1]:
        np.testing.assert_allclose(got.numpy(), [0.5, 0, 0, 0.5], atol=TOL)


def test_density_state_carries_across_packages():
    """A JAX density matrix goes through the port and back as numpy."""
    plan = compile_circuit(random_circuit(5, 2, seed=3), window=3)
    start = jp.apply_plan_density_planar(jp.zero_density_planar(5), plan)
    mid = qbot_tpu_torch.planar_from_numpy(np.asarray(start), "cpu")
    assert mid.shape == (2, 32, 32) and mid.dtype == torch.float32
    out = qbot_tpu_torch.planar_to_numpy(tp.apply_plan_density_planar(mid,
                                                                      plan))
    want = np.asarray(jp.apply_plan_density_planar(start, plan))
    np.testing.assert_allclose(out, want, atol=TOL)


def test_parameterised_density_raises():
    c = Circuit(3)
    c.pry(0)
    c.cx(0, 2)
    plan = compile_circuit(c)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        tp.apply_plan_density_planar(tp.zero_density_planar(3, "cpu"), plan)
