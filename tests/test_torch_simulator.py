"""The port's complex simulator (``qbot_tpu_torch.tpu.simulator``) on the
CPU vs ``qbot_tpu.tpu.simulator`` on CPU-JAX (x64), function by function,
on the same plans and numpy-seeded states and angles, in both complex
dtypes; and ``run_lowered(use_planar=False)`` against ``qbot_tpu``'s.

Tolerance: 1e-6 in complex128 (products and sums of a few dozen steps in
another order), 1e-5 in complex64, on amplitudes, density entries and
probabilities.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import both, brickwork, grover_body
from qbot_tpu.frontend import lowering as jl
from qbot_tpu.tpu import compiler as jc
from qbot_tpu.tpu import simulator as js
from qbot_tpu_torch import lower_program, run_lowered
from qbot_tpu_torch.tpu import simulator as ts
from qbot_tpu_torch.tpu.compiler import WindowStep, compile_circuit

from test_torch_grad import N, _param_circuit

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DTYPES = {"complex128": (torch.complex128, jnp.complex128, 1e-6),
          "complex64": (torch.complex64, jnp.complex64, 1e-5)}


def _rand_ket(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    return psi / np.linalg.norm(psi)


def _circuits(m):
    """Static windows and pairs, a reflection with fused flips, a
    controlled phase across windows, and parameterised gates."""
    return {"brickwork": brickwork(m, N, 3, seed=2),
            "grover": m.grover_circuit(N, 77, iterations=2),
            "grover_body": grover_body(m, N, 345),
            "qft": m.qft_circuit(N),
            "param": _param_circuit(m)}


CASES = ["brickwork", "grover", "grover_body", "qft", "param"]


def _plans(name, window=3):
    circ, jcirc = both(lambda m: _circuits(m)[name])
    return (circ, compile_circuit(circ, window=window),
            jc.compile_circuit(jcirc, window=window))


def _theta(circ):
    return np.linspace(-0.6, 1.4, circ.num_params) if circ.num_params \
        else None


def _args(theta, dtype_t):
    """(port's params, reference's params) of the same angles."""
    if theta is None:
        return None, None
    real = torch.float64 if dtype_t == torch.complex128 else torch.float32
    return (torch.tensor(theta, dtype=real),
            jnp.asarray(theta, jnp.float64 if real == torch.float64
                        else jnp.float32))


def test_zero_state_matches_reference():
    for dtype_t, dtype_j, _ in DTYPES.values():
        got = ts.zero_state(5, dtype_t, "cpu")
        assert got.dtype == dtype_t and got.shape == (32,)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(js.zero_state(5, dtype_j)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["brickwork", "param"])
def test_fold_window_matches_reference(name, dtype):
    dtype_t, dtype_j, tol = DTYPES[dtype]
    circ, plan, jplan = _plans(name)
    params, jparams = _args(_theta(circ), dtype_t)
    windows = [(s, j) for s, j in zip(plan.steps, jplan.steps)
               if isinstance(s, WindowStep)]
    assert windows
    for step, jstep in windows:
        got = ts.fold_window(step, params, dtype_t, "cpu")
        want = js.fold_window(jstep, jparams, dtype_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_apply_plan_matches_reference(name, dtype):
    dtype_t, dtype_j, tol = DTYPES[dtype]
    circ, plan, jplan = _plans(name)
    params, jparams = _args(_theta(circ), dtype_t)
    ket = _rand_ket(N, len(name))
    got = ts.apply_plan(torch.tensor(ket, dtype=dtype_t), plan, params)
    want = jax.jit(lambda p, th: js.apply_plan(p, jplan, th))(
        jnp.asarray(ket, dtype_j), jparams)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    run = ts.make_statevector_runner(plan)
    np.testing.assert_allclose(
        run(torch.tensor(ket, dtype=dtype_t), params).numpy(),
        np.asarray(want), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["brickwork", "grover_body", "param"])
def test_apply_plan_density_matches_reference(name, dtype):
    """ρ = |ψ⟩⟨ψ| of a random ket at 7 qubits through every step kind."""
    dtype_t, dtype_j, tol = DTYPES[dtype]
    make = {"brickwork": lambda m: brickwork(m, 8, 2, seed=5),
            "grover_body": lambda m: grover_body(m, 8, 77),
            "param": lambda m: _param_circuit(m, 8)}[name]
    circ, jcirc = both(make)
    plan = compile_circuit(circ, window=3)
    jplan = jc.compile_circuit(jcirc, window=3)
    params, jparams = _args(_theta(circ), dtype_t)
    ket = _rand_ket(8, 3)
    rho = np.outer(ket, ket.conj())
    got = ts.apply_plan_density(torch.tensor(rho, dtype=dtype_t), plan,
                                params)
    want = jax.jit(lambda r, th: js.apply_plan_density(r, jplan, th))(
        jnp.asarray(rho, dtype_j), jparams)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    run = ts.make_density_runner(plan)
    np.testing.assert_allclose(
        run(torch.tensor(rho, dtype=dtype_t), params).numpy(),
        np.asarray(want), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_make_scanned_runner_matches_reference(dtype):
    dtype_t, dtype_j, tol = DTYPES[dtype]
    # (a reflection body promotes the reference's complex64 carry to
    # complex128 under x64, which its scan refuses)
    body, jbody = both(lambda m: brickwork(m, N, 1, seed=9))
    init, jinit = both(lambda m: _param_circuit(m))
    params, jparams = _args(_theta(init), dtype_t)
    got = ts.make_scanned_runner(compile_circuit(body), 4,
                                 compile_circuit(init))(
        ts.zero_state(N, dtype_t, "cpu"), params)
    want = js.make_scanned_runner(jc.compile_circuit(jbody), 4,
                                  jc.compile_circuit(jinit))(
        js.zero_state(N, dtype_j), jparams)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_readout_matches_reference(dtype):
    dtype_t, dtype_j, tol = DTYPES[dtype]
    ket = _rand_ket(N, 11)
    psi, jpsi = torch.tensor(ket, dtype=dtype_t), jnp.asarray(ket, dtype_j)
    for targets in (None, [3], [7, 1, 4], list(range(N))):
        np.testing.assert_allclose(
            ts.computation_probs(psi, targets, N).numpy(),
            np.asarray(js.computation_probs(jpsi, targets, N)), atol=tol)
    np.testing.assert_allclose(ts.computation_probs(psi).numpy(),
                               np.asarray(js.computation_probs(jpsi)),
                               atol=tol)
    for q in (0, 5, N - 1):
        assert float(ts.expectation_z(psi, q)) == pytest.approx(
            float(js.expectation_z(jpsi, q)), abs=tol)


def test_apply_plan_grad_matches_reference():
    """∂ Σ_k c_k·p_k(θ)/∂θ through the simulator, against ``jax.grad``
    (complex128)."""
    circ, plan, jplan = _plans("param")
    theta = _theta(circ)
    c = np.random.default_rng(4).normal(size=2**N)

    def loss_t(t):
        p = ts.computation_probs(ts.apply_plan(
            ts.zero_state(N, torch.complex128, "cpu"), plan, t))
        return torch.sum(torch.from_numpy(c) * p)

    t = torch.tensor(theta, requires_grad=True)
    (got,) = torch.autograd.grad(loss_t(t), t)
    want = jax.jit(jax.grad(lambda th: jnp.sum(c * js.computation_probs(
        js.apply_plan(js.zero_state(N, jnp.complex128), jplan, th)))))(
        jnp.asarray(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_missing_params_raise():
    circ, plan, _ = _plans("param")
    with pytest.raises(ValueError, match="pass params"):
        ts.apply_plan(ts.zero_state(N, device="cpu"), plan)


EXAMPLES = ["deutsch.qb", "grover.qb", "phase_kickback.qb", "superdense.qb",
            "teleportation.qb"]
PROGRAMS = {"bell_basis": ("qset tensorProd(comp[0], comp[0])\n"
                           "gate hadamardGate ; 0\n"
                           "gate pauliXGate ; 1 ; 0\n"
                           "meas out ; bell"),
            "subset": ("qset tensorProd(comp[1], hada[0], comp[0])\n"
                       "meas out ; comp ; [0, 2]")}


@pytest.mark.parametrize("name", EXAMPLES + list(PROGRAMS))
def test_run_lowered_complex_matches_reference(name):
    src = PROGRAMS.get(name) or (ROOT / "examples" / name).read_text()
    lp_t, lp_j = lower_program(src), jl.lower_program(src)
    probs_t, psi = run_lowered(lp_t, use_planar=False, device="cpu")
    probs_j, _ = jl.run_lowered(lp_j, use_planar=False)
    assert psi.dtype == torch.complex64 and psi.dim() == 1
    np.testing.assert_allclose(probs_t, np.asarray(probs_j), atol=1e-5)
    planar, _ = run_lowered(lower_program(src), device="cpu")
    np.testing.assert_allclose(probs_t, planar, atol=1e-5)
