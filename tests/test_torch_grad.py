"""Gradients through the port's kernel wrappers and executors on the CPU,
against PyTorch's own autograd through the kernels' plain versions and
against ``jax.vjp`` / ``jax.grad`` of ``qbot_tpu``'s custom VJPs, on the
same numpy-seeded inputs.

On the CPU each ``torch.autograd.Function`` runs its forward and its
backward through the plain versions (the wrappers dispatch on the tensor's
device), so these tests hold the Functions' adjoint algebra; the card tests
(``tests/test_torch_cuda.py``) hold the same Functions through the CUDA
kernels.  ``qbot_tpu``'s VJPs run its XLA route, one window case also its
Pallas kernels in interpret mode (as ``tests/test_inference.py`` does).

Tolerances: relative L2 1e-5 for every cotangent (float32 products and
sums of at most a few thousand terms, taken in another order); the
parameterised fold 1e-6 absolute against the reference's float32 fold
(ours folds in float64 and rounds once); whole plans 1e-5 absolute on
amplitudes, as the forward parity tests.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import both, grover_body
from qbot_tpu.inference import ensemble_exec as jee
from qbot_tpu.ops import gates as jgates
from qbot_tpu.tpu import compiler as jc
from qbot_tpu.tpu import kernels as jk
from qbot_tpu.tpu import planar as jp
from qbot_tpu_torch.inference import ensemble_exec as tee
from qbot_tpu_torch.ops import gates as tgates
from qbot_tpu_torch.tpu import kernels as tk
from qbot_tpu_torch.tpu import planar as tp
from qbot_tpu_torch.tpu.compiler import (
    PairStep,
    ReflectStep,
    WindowStep,
    compile_circuit,
)

from test_torch_kernels import (
    GEOMETRIES,
    PAIR_GEOMETRIES,
    _diagonals,
    _pair_diagonals,
    _rand_state,
    _rand_unitary,
)

torch.set_num_threads(1)

REL = 1e-5
FOLD_TOL = 1e-6
TOL = 1e-5

# a pair geometry of each route, for the comparisons with qbot_tpu
PAIR_JAX = ("trailing", "middle", "two_windows_wide", "middle_narrow_2x32",
            "middle_stream_4x4")


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _planar(u):
    return np.stack([u.real, u.imag]).astype(np.float32)


def _batch(n, rng, particles):
    """One state (2, 2^n), or a batch (P, 2, 2^n), float32."""
    if particles is None:
        return _rand_state(n, rng)
    return np.stack([_rand_state(n, rng) for _ in range(particles)])


def _grads(fn, inputs, cot):
    """Cotangents of ⟨cot, fn(*inputs)⟩ with respect to every input."""
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = fn(*xs)
    return torch.autograd.grad(out, xs, torch.from_numpy(cot))


# ---------------------------------------------------------------------------
# the window: kernels.py:806-848
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("particles", [None, 3], ids=["state", "batch"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_window_grad_matches_plain_autograd(geometry, particles):
    n, start, width = GEOMETRIES[geometry]
    rng = np.random.default_rng(50 + len(geometry))
    psi = _batch(n, rng, particles)
    w = _planar(_rand_unitary(2**width, rng))
    cot = rng.normal(size=psi.shape).astype(np.float32)
    diag = tk.fused_diagonals(n, *_diagonals(n, start, width, rng))

    got = _grads(lambda p, m: tk.window_apply(p, n, start, width, m, diag),
                 (psi, w), cot)
    want = _grads(lambda p, m: tk.window_apply_ref(p, n, start, width, m,
                                                   diag), (psi, w), cot)
    for g, h in zip(got, want):
        assert rel_l2(g, h) <= REL


def _jax_vjp(fn, inputs, cot):
    """``jax.vjp`` of ``fn`` at ``inputs`` applied to ``cot``, jitted (one
    compile in place of one a primitive)."""
    run = jax.jit(lambda c, *xs: jax.vjp(fn, *xs)[1](c))
    return [np.asarray(x) for x in run(jnp.asarray(cot),
                                       *(jnp.asarray(x) for x in inputs))]


def _jax_window_vjp(psi, w, n, start, width, flips, phases, cot):
    d_psi, d_wr, d_wi = _jax_vjp(
        lambda p, wr, wi: jk.planar_window_apply(p, n, start, width, wr, wi,
                                                 flips, phases),
        (psi, w[0], w[1]), cot)
    return d_psi, np.stack([d_wr, d_wi])


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_window_grad_matches_jax_vjp(geometry):
    n, start, width = GEOMETRIES[geometry]
    rng = np.random.default_rng(60 + len(geometry))
    psi = _rand_state(n, rng)
    w = _planar(_rand_unitary(2**width, rng))
    cot = rng.normal(size=psi.shape).astype(np.float32)
    flips, phases = _diagonals(n, start, width, rng)
    diag = tk.fused_diagonals(n, flips, phases)

    d_psi, d_w = _grads(
        lambda p, m: tk.window_apply(p, n, start, width, m, diag),
        (psi, w), cot)
    want_psi, want_w = _jax_window_vjp(psi, w, n, start, width, flips,
                                       phases, cot)
    assert rel_l2(d_psi, want_psi) <= REL
    assert rel_l2(d_w, want_w) <= REL


def test_window_grad_matches_pallas_interpret():
    """The reference's VJP through its Pallas kernels (interpret mode): the
    window at B >= 128, where the left-multiply kernel runs."""
    n, start, width = GEOMETRIES["middle"]
    rng = np.random.default_rng(70)
    psi = _rand_state(n, rng)
    w = _planar(_rand_unitary(2**width, rng))
    cot = rng.normal(size=psi.shape).astype(np.float32)
    flips, phases = _diagonals(n, start, width, rng)
    diag = tk.fused_diagonals(n, flips, phases)
    d_psi, d_w = _grads(
        lambda p, m: tk.window_apply(p, n, start, width, m, diag),
        (psi, w), cot)
    jk.set_kernel_mode("interpret")
    try:
        want_psi, want_w = _jax_window_vjp(psi, w, n, start, width, flips,
                                           phases, cot)
    finally:
        jk.set_kernel_mode("auto")
    assert rel_l2(d_psi, want_psi) <= REL
    assert rel_l2(d_w, want_w) <= REL


# ---------------------------------------------------------------------------
# the pair: kernels.py:851-915
# ---------------------------------------------------------------------------

def _pair_inputs(geometry, seed, particles=None):
    n, start, width1, width2 = PAIR_GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    psi = _batch(n, rng, particles)
    w1 = _planar(_rand_unitary(2**width1, rng))
    w2 = _planar(_rand_unitary(2**width2, rng))
    cot = rng.normal(size=psi.shape).astype(np.float32)
    flips, phases = _pair_diagonals(n, start, width1, width2, rng)
    return (n, start, width1, width2), psi, w1, w2, cot, flips, phases


@pytest.mark.parametrize("particles", [None, 3], ids=["state", "batch"])
@pytest.mark.parametrize("geometry", list(PAIR_GEOMETRIES))
def test_pair_grad_matches_plain_autograd(geometry, particles):
    (n, s, w1n, w2n), psi, w1, w2, cot, flips, phases = _pair_inputs(
        geometry, 80 + len(geometry), particles)
    diag = tk.fused_diagonals(n, flips, phases)
    got = _grads(lambda p, a, b: tk.pair_apply(p, n, s, w1n, w2n, a, b,
                                               diag), (psi, w1, w2), cot)
    want = _grads(lambda p, a, b: tk.pair_apply_ref(p, n, s, w1n, w2n, a, b,
                                                    diag), (psi, w1, w2), cot)
    for g, h in zip(got, want):
        assert rel_l2(g, h) <= REL


@pytest.mark.parametrize("geometry", PAIR_JAX)
def test_pair_grad_matches_jax_vjp(geometry):
    (n, s, w1n, w2n), psi, w1, w2, cot, flips, phases = _pair_inputs(
        geometry, 90 + len(geometry))
    diag = tk.fused_diagonals(n, flips, phases)
    got = _grads(lambda p, a, b: tk.pair_apply(p, n, s, w1n, w2n, a, b,
                                               diag), (psi, w1, w2), cot)
    d_psi, d_w1r, d_w1i, d_w2r, d_w2i = _jax_vjp(
        lambda p, ar, ai, br, bi: jk.planar_pair_window_apply(
            p, n, s, w1n, s + w1n, w2n, ar, ai, br, bi, flips, phases),
        (psi, w1[0], w1[1], w2[0], w2[1]), cot)
    assert rel_l2(got[0], d_psi) <= REL
    assert rel_l2(got[1], np.stack([d_w1r, d_w1i])) <= REL
    assert rel_l2(got[2], np.stack([d_w2r, d_w2i])) <= REL


# ---------------------------------------------------------------------------
# the reflection: planar.py:343-370
# ---------------------------------------------------------------------------

def _reflect_steps(n, marked, window):
    """(port's, reference's) ReflectStep of a Grover body with fused
    flips."""
    circ, jcirc = both(lambda m: grover_body(m, n, marked))
    plan = compile_circuit(circ, window=window)
    jplan = jc.compile_circuit(jcirc, window=window)
    step = next(s for s in plan.steps if isinstance(s, ReflectStep))
    jstep = next(s for s in jplan.steps if isinstance(s, jc.ReflectStep))
    assert step.pre_flips
    return step, jstep


# (qubits, marked, window): H·T of 10 qubits at T = 128, and of 12 at 8
REFLECT_CASES = [(10, 345, 7), (12, 77, 3)]


@pytest.mark.parametrize("particles", [None, 3], ids=["state", "batch"])
@pytest.mark.parametrize("n,marked,window", REFLECT_CASES)
def test_reflect_grad_matches_plain_autograd(n, marked, window, particles):
    step, _ = _reflect_steps(n, marked, window)
    rng = np.random.default_rng(n + marked)
    psi = _batch(n, rng, particles)
    cot = rng.normal(size=psi.shape).astype(np.float32)
    kernel = tp._reflect_fn(step, "cpu", tp._KERNELS)
    plain = tp._reflect_fn(step, "cpu", tp._PLAIN)
    (got,) = _grads(lambda p: kernel(p, None), (psi,), cot)
    (want,) = _grads(lambda p: plain(p, None), (psi,), cot)
    assert rel_l2(got, want) <= REL


@pytest.mark.parametrize("n,marked,window", REFLECT_CASES)
def test_reflect_grad_matches_jax_vjp(n, marked, window):
    step, jstep = _reflect_steps(n, marked, window)
    rng = np.random.default_rng(2 * n + marked)
    psi = _rand_state(n, rng)
    cot = rng.normal(size=psi.shape).astype(np.float32)
    kernel = tp._reflect_fn(step, "cpu", tp._KERNELS)
    (got,) = _grads(lambda p: kernel(p, None), (psi,), cot)
    (want,) = _jax_vjp(lambda p: jp._apply_reflect_planar(p, n, jstep),
                       (psi,), cot)
    assert rel_l2(got, want) <= REL


def test_differentiable_steps_run_their_functions():
    """Under autograd the window, pair and reflection go through their
    Functions (whose backward runs the kernels); without it, through the
    launch alone."""
    step, _ = _reflect_steps(*REFLECT_CASES[0])
    rng = np.random.default_rng(3)
    psi = torch.from_numpy(_rand_state(10, rng))
    w = torch.from_numpy(_planar(_rand_unitary(8, rng)))
    none = tk.fused_diagonals(10)
    x = psi.clone().requires_grad_()
    runs = {"_ReflectApply": tp._reflect_fn(step, "cpu", tp._KERNELS)(x, None),
            "_WindowApply": tk.window_apply(x, 10, 2, 3, w, none),
            "_PairApply": tk.pair_apply(x, 10, 2, 3, 3, w, w, none)}
    for name, out in runs.items():
        assert type(out.grad_fn).__name__ == f"{name}Backward", name
    assert tk.window_apply(psi, 10, 2, 3, w, none).grad_fn is None


# ---------------------------------------------------------------------------
# parameterised gates: rot_planar, the fold, whole plans
# ---------------------------------------------------------------------------

XP = {"qbot_tpu_torch.tpu.circuit": torch, "qbot_tpu.tpu.circuit": jnp}


N = 10          # a 3-qubit front window and the 7-qubit last one


def _param_circuit(m, n=N):
    """Every parameterised builder, a controlled parameterised gate inside a
    window and one across windows (a ContractStep at window 3), static
    gates between."""
    xp = XP[m.__name__]
    c = m.Circuit(n)
    for q in range(n):
        c.h(q)
        (c.prx, c.pry, c.prz)[q % 3](q)
    c.param_gate(lambda t: m.g.rot_planar("y", t, xp=xp), [1], controls=[0])
    c.param_gate(lambda t: m.g.rot_planar("x", t, xp=xp), [n - 1],
                 controls=[0], param_idx=2)
    for q in range(0, n - 1, 2):
        c.cx(q, q + 1)
    c.pry(2, 0)
    return c


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rot_planar_matches_reference(axis):
    for theta in (0.0, 0.37, -2.1, np.pi):
        got = tgates.rot_planar(axis, torch.tensor(theta, dtype=torch.float64),
                                xp=torch)
        want = jgates.rot_planar(axis, theta)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-15)
        np.testing.assert_array_equal(tgates.rot_planar(axis, theta), want)
    with pytest.raises(ValueError, match="rotation axis"):
        tgates.rot_planar("w", 0.0)


def test_rot_planar_carries_autograd():
    theta = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    m = tgates.rot_planar("y", theta, xp=torch)
    (g,) = torch.autograd.grad(m[0, 1, 0], theta)       # d sin(θ/2)/dθ
    assert float(g) == pytest.approx(0.5 * np.cos(0.4), abs=1e-15)


@pytest.mark.parametrize("window", [3, 4])
def test_fold_window_planar_matches_reference(window):
    circ, jcirc = both(_param_circuit)
    plan = compile_circuit(circ, window=window, pair=False)
    jplan = jc.compile_circuit(jcirc, window=window, pair=False)
    theta = np.linspace(-0.7, 1.3, circ.num_params)
    params = torch.tensor(theta, dtype=torch.float32)
    folded = 0
    for step, jstep in zip(plan.steps, jplan.steps):
        if not isinstance(step, WindowStep):
            continue
        if all(t.matrix is not None for t in step.terms):
            continue
        got = tp.fold_window_planar(step, params)
        want = np.stack(jp.fold_window_planar(
            jstep, jnp.asarray(theta, jnp.float32)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=FOLD_TOL)
        folded += 1
    assert folded >= 2


def _both_plans(make, window, pair):
    circ, jcirc = both(make)
    return (circ, compile_circuit(circ, window=window, pair=pair),
            jc.compile_circuit(jcirc, window=window, pair=pair))


@pytest.mark.parametrize("pair", [True, False], ids=["paired", "unpaired"])
def test_apply_plan_planar_params_matches_reference(pair):
    circ, plan, jplan = _both_plans(_param_circuit, 3, pair)
    assert any(type(s).__name__ == "ContractStep" and s.maker is not None
               for s in plan.steps)
    assert any(isinstance(s, PairStep) for s in plan.steps) == pair
    theta = np.linspace(0.2, 1.6, circ.num_params)
    psi = _rand_state(N, np.random.default_rng(5))
    got = tp.apply_plan_planar(torch.from_numpy(psi), plan,
                               torch.tensor(theta, dtype=torch.float32))
    want = jax.jit(lambda p, th: jp.apply_plan_planar(p, jplan, th))(
        jnp.asarray(psi), jnp.asarray(theta, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    ref = tp.apply_plan_planar_ref(torch.from_numpy(psi), plan,
                                   torch.tensor(theta, dtype=torch.float32))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=TOL)


def test_apply_plan_planar_params_grad_matches_reference():
    """∂⟨cot, ψ(θ)⟩/∂θ through every step kind's backward (windows, pairs,
    the parameterised contraction) against ``jax.grad``."""
    circ, plan, jplan = _both_plans(_param_circuit, 3, True)
    theta = np.linspace(0.2, 1.6, circ.num_params)
    rng = np.random.default_rng(6)
    psi, cot = _rand_state(N, rng), rng.normal(size=(2, 2**N))
    t = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    out = tp.make_planar_runner(plan)(torch.from_numpy(psi), t)
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(
        cot.astype(np.float32)))
    (want,) = _jax_vjp(lambda th: jp.apply_plan_planar(jnp.asarray(psi),
                                                       jplan, th),
                       (theta.astype(np.float32),), cot.astype(np.float32))
    assert rel_l2(got, want) <= REL


def test_make_planar_runner_prepares_static_steps_once():
    """The runner folds only the parameterised windows per call: its
    static tables are the same tensors on every call."""
    circ, plan, _ = _both_plans(_param_circuit, 3, False)
    run = tp.make_planar_runner(plan)
    psi = torch.from_numpy(_rand_state(N, np.random.default_rng(7)))
    a = run(psi, torch.zeros(circ.num_params))
    b = run(psi, torch.full((circ.num_params,), 0.5))
    assert not torch.equal(a, b)
    np.testing.assert_allclose(
        run(psi, torch.full((circ.num_params,), 0.5)).numpy(), b.numpy(),
        atol=0)
    with pytest.raises(ValueError, match="pass params"):
        run(psi)


def test_apply_plan_density_planar_params_matches_reference():
    circ, plan, jplan = _both_plans(lambda m: _param_circuit(m, 8), 3, True)
    theta = np.linspace(-0.4, 1.1, circ.num_params)
    t = torch.tensor(theta, dtype=torch.float32)
    got = tp.apply_plan_density_planar(tp.zero_density_planar(8, "cpu"),
                                       plan, t)
    want = jax.jit(lambda th: jp.apply_plan_density_planar(
        jp.zero_density_planar(8), jplan, th))(
        jnp.asarray(theta, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    run = tp.make_planar_density_runner(plan)
    np.testing.assert_allclose(
        run(tp.zero_density_planar(8, "cpu"), t).numpy(), np.asarray(want),
        atol=TOL)


def test_apply_plan_ensemble_params_matches_reference():
    """Shared angles on the particle axis, against ``qbot_tpu``'s vmapped
    run."""
    circ, plan, jplan = _both_plans(_param_circuit, 3, True)
    theta = np.linspace(0.1, 0.9, circ.num_params)
    rng = np.random.default_rng(8)
    psi = np.stack([_rand_state(N, rng) for _ in range(3)])
    log_w = np.log(np.array([0.5, 0.3, 0.2]))
    got = tee.apply_plan_ensemble(
        tee.QuantumEnsemble(torch.from_numpy(log_w), torch.from_numpy(psi)),
        plan, torch.tensor(theta, dtype=torch.float32))
    want = jee.apply_plan_ensemble(
        jee.QuantumEnsemble(jnp.asarray(log_w), jnp.asarray(psi)), jplan,
        jnp.asarray(theta, jnp.float32))
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi),
                               atol=TOL)
    np.testing.assert_array_equal(got.log_w.numpy(), log_w)
