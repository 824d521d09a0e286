"""The port's HMC and NUTS (``qbot_tpu_torch.inference.hmc`` / ``.nuts``) on
the CPU: the circuit log-probs and their gradients, the leapfrog and the
NUTS subtree against ``qbot_tpu``'s on the same inputs, and the statistical
tests of ``tests/test_inference.py::TestHMC`` and ``tests/test_nuts.py``
with ``torch.Generator``s, the same sample counts and the same limits.

Tolerances: log-prob values rtol 1e-5 (float32 states, sums in another
order); gradients rtol 2e-3, atol 1e-3 (the reference's own limits
between its planar and complex log-probs); the leapfrog's positions 1e-5
and the subtree's outputs 1e-6 relative (float64 arithmetic of a few
steps; the subtree's booleans and leaf counts equal).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import both
from qbot_tpu.inference import hmc as jh
from qbot_tpu.inference import nuts as jn
from qbot_tpu.tpu import compiler as jc
from qbot_tpu_torch.inference import hmc, nuts
from qbot_tpu_torch.tpu.circuit import Circuit, parameterized_layers
from qbot_tpu_torch.tpu.compiler import PairStep, ReflectStep, compile_circuit

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=2e-3, atol=1e-3)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _layers(m):
    return m.parameterized_layers(8, 2)


def _grover_in_the_loss(m, n=6):
    """``tests/test_inference.py:180-213``: rotations, then one Grover
    body that compiles to a ReflectStep with a fused flip."""
    H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    c = m.Circuit(n)
    for q in range(n):
        c.pry(q, q)
    for q in range(n):
        c.gate(H, [q])
    c.phase_flip(3)
    for q in range(n):
        c.gate(H, [q])
    c.phase_flip(0)
    for q in range(n):
        c.gate(H, [q])
    return c


def _setup(name):
    """(port's plan, reference's plan, counts, θ) of ``tests/
    test_inference.py``'s two planar log-prob cases."""
    if name == "layers":
        circ, jcirc = both(_layers)
        window, n, counts_at, span = 4, 8, {0: 40.0, 3: 24.0}, (0.2, 1.4)
    else:
        circ, jcirc = both(_grover_in_the_loss)
        window, n, counts_at, span = 3, 6, {0: 10.0, 5: 6.0}, (0.3, 1.1)
    plan = compile_circuit(circ, window=window)
    jplan = jc.compile_circuit(jcirc, window=window)
    counts = np.zeros(2**n)
    for k, v in counts_at.items():
        counts[k] = v
    return plan, jplan, counts, np.linspace(*span, circ.num_params)


@pytest.mark.parametrize("name", ["layers", "grover_in_the_loss"])
def test_planar_log_prob_matches_reference(name):
    plan, jplan, counts, theta = _setup(name)
    kinds = {type(s) for s in plan.steps}
    assert (PairStep if name == "layers" else ReflectStep) in kinds
    lp = hmc.make_circuit_log_prob_planar(plan, counts, device="cpu")
    value, grad = hmc.value_and_grad(lp)(torch.tensor(theta,
                                                      dtype=torch.float32))
    want_v, want_g = jax.jit(jax.value_and_grad(
        jh.make_circuit_log_prob_planar(jplan, jnp.asarray(counts))))(
        jnp.asarray(theta, jnp.float32))
    assert float(value) == pytest.approx(float(want_v), rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), **GRAD_TOL)


@pytest.mark.parametrize("name", ["layers", "grover_in_the_loss"])
def test_complex_log_prob_matches_reference(name):
    """The simulator's log-prob in complex64, against the reference's, and
    the planar gradient against it (the reference's own test)."""
    plan, jplan, counts, theta = _setup(name)
    lp = hmc.make_circuit_log_prob(plan, counts, device="cpu")
    value, grad = hmc.value_and_grad(lp)(torch.tensor(theta,
                                                      dtype=torch.float32))
    want_v, want_g = jax.jit(jax.value_and_grad(
        jh.make_circuit_log_prob(jplan, jnp.asarray(counts))))(
        jnp.asarray(theta, jnp.float32))
    assert float(value) == pytest.approx(float(want_v), rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), **GRAD_TOL)
    _, planar = hmc.value_and_grad(hmc.make_circuit_log_prob_planar(
        plan, counts, device="cpu"))(torch.tensor(theta,
                                                  dtype=torch.float32))
    np.testing.assert_allclose(planar.numpy(), grad.numpy(), **GRAD_TOL)


def _log_probs_128():
    """(port's, reference's) complex128 log-prob of the 8-qubit layers."""
    plan, jplan, counts, theta = _setup("layers")
    return (hmc.make_circuit_log_prob(plan, counts, dtype=torch.complex128,
                                      device="cpu"),
            jh.make_circuit_log_prob(jplan, jnp.asarray(counts),
                                     dtype=jnp.complex128), theta)


def test_leapfrog_matches_reference():
    lp, jlp, theta = _log_probs_128()
    p = np.random.default_rng(3).normal(size=theta.shape)
    vg = hmc.value_and_grad(lp)
    _, g0 = vg(torch.tensor(theta))
    q, r, grad, value = hmc._leapfrog(vg, torch.tensor(theta),
                                      torch.tensor(p), g0, 0.05, 3)
    jvg = jax.jit(jax.value_and_grad(jlp))
    _, jg0 = jvg(jnp.asarray(theta))
    jq, jr, jgrad = jh._leapfrog(jvg, jnp.asarray(theta), jnp.asarray(p),
                                 jg0, 0.05, 3)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-8)
    assert float(value) == pytest.approx(float(jlp(jq)), rel=1e-10)


def _gauss(mean, var, xp):
    mean, var = xp.asarray(mean), xp.asarray(var)
    return lambda theta: -0.5 * xp.sum((theta - mean) ** 2 / var)


# (start, momentum, step, leaves, variance): a subtree that runs its 8
# leaves, one that turns back, one that diverges
SUBTREES = {"runs": ([2.0, -1.0, 0.5], [0.3, 0.2, -0.1], 0.05, 8, 1.0),
            "turns": ([2.0, -1.0, 0.5], [0.3, 0.2, -0.1], 0.6, 16, 1.0),
            "diverges": ([1.0, 1.0, 1.0], [1.0, 0.0, 0.0], 50.0, 4, 1e-6)}


@pytest.mark.parametrize("case", list(SUBTREES))
def test_build_subtree_matches_reference(case):
    q0, r0, eps, leaves, var = SUBTREES[case]
    q0, r0 = np.asarray(q0), np.asarray(r0)
    lp = _gauss(np.zeros(3), np.full(3, var), torch)
    jlp = _gauss(np.zeros(3), np.full(3, var), jnp)
    vg, jvg = hmc.value_and_grad(lp), jax.value_and_grad(jlp)
    lp0, g0 = vg(torch.tensor(q0))
    energy0 = float(lp0) - 0.5 * float(r0 @ r0)
    sub = nuts._build_subtree(vg, torch.tensor(q0), torch.tensor(r0), g0,
                              eps, leaves, 6, energy0, _gen(0))
    (jq, jr, jgrad, _, _, _, lsw, turning, diverged, s_acc,
     i) = jn._build_subtree(jvg, jnp.asarray(q0), jnp.asarray(r0),
                            jvg(jnp.asarray(q0))[1], eps, leaves, 6,
                            jnp.asarray(energy0), jax.random.PRNGKey(0))
    assert (sub.turning, sub.diverged, sub.num_leaves) == (
        bool(turning), bool(diverged), int(i))
    assert {"runs": (False, False), "turns": (True, False),
            "diverges": (False, True)}[case] == (sub.turning, sub.diverged)
    for got, want in ((sub.q, jq), (sub.r, jr), (sub.grad, jgrad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert sub.log_sum_w == pytest.approx(float(lsw), rel=1e-6)
    assert sub.sum_accept == pytest.approx(float(s_acc), rel=1e-6)


# ---------------------------------------------------------------------------
# tests/test_inference.py::TestHMC, with torch generators
# ---------------------------------------------------------------------------

class TestHMC:
    def setup_method(self):
        # posterior over a single rotation angle given measurement counts:
        # circuit = Ry(θ)|0⟩, observed mostly |1⟩ → θ near π
        self.plan = compile_circuit(parameterized_layers(1, 1))
        self.log_prob = hmc.make_circuit_log_prob(
            self.plan, np.array([5.0, 95.0]), dtype=torch.complex128,
            device="cpu")

    def test_log_prob_peak(self):
        lp_pi = float(self.log_prob(torch.tensor([np.pi])))
        lp_0 = float(self.log_prob(torch.tensor([0.1])))
        assert lp_pi > lp_0

    def test_gradient_flows(self):
        _, g = hmc.value_and_grad(self.log_prob)(torch.tensor([1.0]))
        assert np.isfinite(float(g[0])) and abs(float(g[0])) > 0

    def test_hmc_converges_to_posterior(self):
        qs, lps = hmc.run_hmc(_gen(2), self.log_prob, torch.tensor([1.0]),
                              200, step_size=0.05, num_leapfrog=8)
        samples = qs.numpy()[100:, 0]
        # Ry(θ)|0⟩ has P(|1⟩)=sin²(θ/2)=0.95 → θ ≈ π±0.45; accept either sign
        assert abs(abs(np.median(samples)) % (2 * np.pi) - np.pi) < 0.6

    def test_multi_chain(self):
        theta0 = torch.tensor([[0.5], [1.5]], dtype=torch.float64)
        qs, lps = hmc.run_hmc_chains(_gen(3), self.log_prob, theta0, 10,
                                     step_size=0.05)
        assert qs.shape == (2, 10, 1) and lps.shape == (2, 10)

    def test_dual_averaging_warmup(self):
        eps, state = hmc.dual_averaging_warmup(
            _gen(4), self.log_prob, torch.tensor([1.0], dtype=torch.float64),
            num_warmup=50)
        assert 1e-4 < float(eps) < 10.0
        assert np.isfinite(float(state.log_prob))


def test_chain_generators_follow_the_callers():
    """Each chain's generator is seeded from the caller's: the same caller
    seed gives the same chains, the chains differ from each other."""
    a = [torch.rand(3, generator=g) for g in hmc.chain_generators(_gen(9), 3)]
    b = [torch.rand(3, generator=g) for g in hmc.chain_generators(_gen(9), 3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


def test_hmc_chain_runs_planar():
    plan, _, counts, theta = _setup("layers")
    lp = hmc.make_circuit_log_prob_planar(plan, counts, device="cpu")
    t = torch.tensor(theta, dtype=torch.float32)
    qs, lps = hmc.run_hmc_chains(_gen(0), lp, torch.stack([t, t + 0.1]), 4,
                                 step_size=0.05, num_leapfrog=3)
    assert qs.shape == (2, 4, theta.shape[0])
    assert torch.isfinite(lps).all()


# ---------------------------------------------------------------------------
# tests/test_nuts.py, with torch generators
# ---------------------------------------------------------------------------

def _gauss_t(mean, var):
    return _gauss(torch.tensor(mean, dtype=torch.float64),
                  torch.tensor(var, dtype=torch.float64), torch)


def _f64(x):
    return torch.tensor(x, dtype=torch.float64)


class TestNutsStep:
    def test_single_step_moves_and_is_finite(self):
        lp = _gauss_t([0.0] * 3, [1.0] * 3)
        state = hmc.hmc_init(lp, _f64([2.0, -1.0, 0.5]))
        new, stats = nuts.nuts_step(_gen(0), state, lp, 0.3,
                                    max_tree_depth=6)
        assert torch.isfinite(new.position).all()
        assert float(stats.accept_prob) > 0.0
        assert int(stats.num_leaves) >= 1
        assert not bool(stats.diverged)

    def test_tree_depth_bounded(self):
        lp = _gauss_t([0.0] * 2, [1.0] * 2)
        state = hmc.hmc_init(lp, _f64([0.0, 0.0]))
        _, stats = nuts.nuts_step(_gen(1), state, lp, 0.05, max_tree_depth=4)
        assert int(stats.depth) <= 4
        assert int(stats.num_leaves) <= 2**4

    def test_divergence_flag_on_huge_step(self):
        # a pathological step size on a narrow target must diverge or turn,
        # never produce NaNs in the kept position
        lp = _gauss_t([0.0] * 2, [1e-6] * 2)
        state = hmc.hmc_init(lp, _f64([1.0, 1.0]))
        new, stats = nuts.nuts_step(_gen(2), state, lp, 50.0,
                                    max_tree_depth=6)
        assert torch.isfinite(new.position).all()


class TestNutsChain:
    def test_gaussian_moments(self):
        mean, var = [1.0, -2.0], [1.0, 0.25]
        qs, lps, stats = nuts.run_nuts(_gen(3), _gauss_t(mean, var),
                                       _f64([0.0, 0.0]), 800, step_size=0.5,
                                       max_tree_depth=6)
        samples = qs[200:].numpy()
        assert np.allclose(samples.mean(axis=0), mean, atol=0.25)
        assert np.allclose(samples.var(axis=0), var, atol=0.3)
        # healthy sampling: almost no divergences, decent acceptance
        assert float(stats.diverged.double().mean()) < 0.02
        assert float(stats.accept_prob.mean()) > 0.4

    def test_correlated_gaussian(self):
        prec = _f64([[2.0, 1.2], [1.2, 2.0]])
        qs, _, _ = nuts.run_nuts(_gen(4), lambda t: -0.5 * t @ prec @ t,
                                 _f64([0.0, 0.0]), 1000, step_size=0.4,
                                 max_tree_depth=7)
        cov = np.cov(qs[200:].numpy().T)
        assert np.allclose(cov, np.linalg.inv(prec.numpy()), atol=0.35)

    def test_multichain(self):
        lp = _gauss_t([0.0] * 2, [1.0] * 2)
        theta0 = _f64([[0.0, 0.0], [1.0, 1.0], [-1.0, -1.0], [2.0, 2.0]])
        qs, lps, stats = nuts.run_nuts_chains(_gen(5), lp, theta0, 50,
                                              step_size=0.5)
        assert qs.shape == (4, 50, 2) and stats.num_leaves.shape == (4, 50)
        assert torch.isfinite(qs).all()
        # chains must decorrelate: distinct starting points end different
        finals = qs[:, -1].numpy()
        assert len({tuple(np.round(f, 6)) for f in finals}) == 4


class TestNutsWarmup:
    def test_step_size_adapts_to_scale(self):
        lp = _gauss_t([0.0] * 2, [0.01] * 2)
        eps, state = nuts.nuts_warmup(_gen(6), lp, _f64([0.0, 0.0]),
                                      num_warmup=80, init_step_size=1.0)
        # target sd is 0.1; adapted step size must shrink well below init
        assert float(eps) < 0.6
        assert torch.isfinite(state.position).all()


class TestNutsCircuitPosterior:
    def test_recovers_rotation_angle(self):
        # 1-qubit Ry(θ): P(1) = sin²(θ/2); observe counts from θ*=π/2
        circ = Circuit(1)
        circ.pry(0)
        true_p1 = 0.5
        lp = hmc.make_circuit_log_prob(
            compile_circuit(circ),
            np.array([1000 * (1 - true_p1), 1000 * true_p1]), device="cpu")
        eps, warm = nuts.nuts_warmup(_gen(7), lp, torch.tensor([0.3]),
                                     num_warmup=60, init_step_size=0.1)
        qs, _, stats = nuts.run_nuts(_gen(8), lp, warm.position, 300,
                                     step_size=float(eps), max_tree_depth=6)
        p1_samples = np.sin(qs[50:].numpy().ravel() / 2) ** 2
        assert abs(p1_samples.mean() - true_p1) < 0.05
