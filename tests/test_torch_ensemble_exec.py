"""The port's device ensemble executor (``qbot_tpu_torch/inference/
ensemble_exec.py``) against ``qbot_tpu.inference.ensemble_exec``, on the
CPU, and the plain kernels' particle axis.

Both packages start from the same ensemble, made with one numpy seed
(``QuantumEnsemble.from_numpy`` carries the reference's numpy arrays into
the port); circuits are built in both from the same seed
(``tests/_torch_parity.py``).  Tolerance: 1e-5 on every outcome
probability and on every entry of an ensemble's mixture Σ w|ψ⟩⟨ψ|
(float32 states, summed in another order).  A prune among equal weights
keeps the reference's branches, index for index.  Sampled collapses draw
from another generator than the reference's: their pre-sampling
distribution agrees within 1e-5, their sampled mixture within 4σ of the
exact fan-out.  The plain kernels on a (P, 2, 2^n) batch equal a loop over
the single particles bit for bit, in every dot mode.  The initial planar
state ``run_lowered_ensemble`` keeps on a ``LoweredProgram``: runs on it
repeat a freshly lowered program's bit for bit, no run writes into it or
hands it out, and it is built anew for rebound kets or another device.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import both, brickwork, grover_body
from portbench.families.smc_program import smc_program
from qbot_tpu.inference import ensemble_exec as jee
from qbot_tpu.tpu.compiler import compile_circuit as jax_compile
from qbot_tpu_torch.frontend import lowering
from qbot_tpu_torch.inference import ensemble_exec as ee
from qbot_tpu_torch.tpu import kernels
from qbot_tpu_torch.tpu.compiler import compile_circuit
from qbot_tpu_torch.tpu.planar import product_state_planar
from qbot_tpu_torch.utils import profiling

torch.set_num_threads(1)

TOL = 1e-5


def _random_ensemble(n, B, seed, lost=0.0):
    """(the port's ensemble, the reference's) of B random normalised
    planar states and random weights."""
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(B, 2, 2**n)).astype(np.float32)
    psi /= np.sqrt((psi.astype(np.float64) ** 2).sum(
        axis=(1, 2), keepdims=True)).astype(np.float32)
    lw = np.log(rng.dirichlet(np.ones(B)))
    return (ee.QuantumEnsemble.from_numpy(lw, psi, lost, "cpu"),
            jee.QuantumEnsemble(jnp.asarray(lw), jnp.asarray(psi), lost))


def _uniform_ensemble(n, B):
    """B copies of the uniform superposition: every outcome probability
    is exact (a power of 2), so the fan-outs' weights tie exactly in both
    packages."""
    psi = np.zeros((B, 2, 2**n), np.float32)
    psi[:, 0] = 2.0 ** (-n / 2)
    lw = np.full(B, -np.log(B))
    return (ee.QuantumEnsemble.from_numpy(lw, psi, 0.0, "cpu"),
            jee.QuantumEnsemble(jnp.asarray(lw), jnp.asarray(psi)))


def _mixture_close(got, want, tol=TOL):
    np.testing.assert_allclose(ee.ensemble_mixture(got),
                               jee.ensemble_mixture(want), atol=tol)


def _same_ensemble(got, want, tol=TOL):
    """Particle for particle: weights, states and lost mass."""
    assert got.num_particles == want.num_particles
    np.testing.assert_allclose(got.weights().numpy(),
                               np.asarray(want.weights()), atol=tol)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi),
                               atol=tol)
    assert abs(float(got.lost_mass) - float(want.lost_mass)) <= tol


def _contract_circuit(m, n):
    """A plan with ContractStep: gates on qubits in distant windows."""
    rng = np.random.default_rng(5)
    u, _ = np.linalg.qr(rng.normal(size=(4, 4))
                        + 1j * rng.normal(size=(4, 4)))
    c = m.Circuit(n)
    for q in range(n):
        c.h(q)
    c.gate(u, [0, n - 1])
    c.ry(3, 0.4)
    return c


PLANS = {
    "paired": lambda m: brickwork(m, 9, 3, seed=1),
    "reflect": lambda m: grover_body(m, 8, 77),
    "contract": lambda m: _contract_circuit(m, 9),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_apply_plan_ensemble(name):
    mt, mj = both(PLANS[name])
    window = 3 if name == "contract" else 7
    plan_t, plan_j = (compile_circuit(mt, window=window),
                      jax_compile(mj, window=window))
    kinds = {type(s).__name__ for s in plan_t.steps}
    assert {"paired": "PairStep", "reflect": "ReflectStep",
            "contract": "ContractStep"}[name] in kinds
    got, want = _random_ensemble(mt.n, 4, seed=len(name))
    _same_ensemble(ee.apply_plan_ensemble(got, plan_t),
                   jee.apply_plan_ensemble(want, plan_j))


@pytest.mark.parametrize("targets", [[0], [4], [1, 3], [4, 0]])
def test_peek_probs(targets):
    got, want = _random_ensemble(5, 3, seed=sum(targets))
    np.testing.assert_allclose(ee.peek_probs(got, 5, targets).numpy(),
                               np.asarray(jee.peek_probs(want, 5, targets)),
                               atol=TOL)


@pytest.mark.parametrize("mode", ["reference", "projective"])
@pytest.mark.parametrize("targets,max_particles",
                         [([0], 256), ([2, 4], 256), ([1, 3], 7),
                          ([4], 3)])
def test_measure_fanout(mode, targets, max_particles):
    n = 5
    got, want = _random_ensemble(n, 3, seed=len(targets) + max_particles,
                                 lost=0.01)
    g, gd = ee.measure_fanout(got, n, targets, max_particles, mode=mode)
    w, wd = jee.measure_fanout(want, n, targets, max_particles, mode=mode)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=TOL)
    _same_ensemble(g, w)
    _mixture_close(g, w)


@pytest.mark.parametrize("mode", ["reference", "projective"])
def test_measure_fanout_prunes_ties_as_the_reference(mode):
    """All branch weights equal: the prune keeps the lower indices, as
    ``jax.lax.top_k`` does, so both keep the same branches."""
    n = 4
    got, want = _uniform_ensemble(n, 2)
    g, _ = ee.measure_fanout(got, n, [1, 2], 5, mode=mode)
    w, _ = jee.measure_fanout(want, n, [1, 2], 5, mode=mode)
    assert g.num_particles == 5
    np.testing.assert_array_equal(g.psi.numpy(), np.asarray(w.psi))
    np.testing.assert_allclose(g.log_w.numpy(), np.asarray(w.log_w),
                               atol=1e-12)
    assert float(g.lost_mass) == pytest.approx(float(w.lost_mass),
                                               abs=1e-12)


@pytest.mark.parametrize("targets,max_particles",
                         [([1], 256), ([0, 3], 256), ([2, 4], 5)])
def test_discard_fanout(targets, max_particles):
    n = 5
    got, want = _random_ensemble(n, 3, seed=7 + len(targets))
    g = ee.discard_fanout(got, n, targets, max_particles)
    w = jee.discard_fanout(want, n, targets, max_particles)
    assert g.psi.shape == (g.num_particles, 2, 2 ** (n - len(targets)))
    _same_ensemble(g, w)


def _new_states(t, seed, mixed):
    """((weight, planar ket), ...) of a random pure or mixed t-qubit new
    state."""
    rng = np.random.default_rng(seed)
    kets = rng.normal(size=(2, 2**t)) + 1j * rng.normal(size=(2, 2**t))
    kets /= np.linalg.norm(kets, axis=1, keepdims=True)
    weights = (0.35, 0.65) if mixed else (1.0,)
    return tuple((w, np.stack([k.real, k.imag]).astype(np.float32))
                 for w, k in zip(weights, kets))


@pytest.mark.parametrize("targets,mixed,max_particles",
                         [([2], False, 256), ([3, 0], True, 256),
                          ([1, 4], True, 6)])
def test_replace_fanout(targets, mixed, max_particles):
    n = 5
    got, want = _random_ensemble(n, 3, seed=11 + len(targets))
    ns = _new_states(len(targets), 3, mixed)
    g = ee.replace_fanout(got, n, targets, ns, max_particles)
    w = jee.replace_fanout(want, n, targets, ns, max_particles)
    _same_ensemble(g, w)


def test_concat_weighted():
    a_t, a_j = _random_ensemble(4, 3, seed=1, lost=0.02)
    b_t, b_j = _random_ensemble(4, 2, seed=2)
    for cap in (256, 4):
        g = ee.concat_weighted([(0.3, a_t), (0.7, b_t)], cap)
        w = jee.concat_weighted([(0.3, a_j), (0.7, b_j)], cap)
        _same_ensemble(g, w)


def test_init_mixed_ensemble():
    """The same ρ in both packages: the mixtures agree (eigenvectors are
    defined only up to phase and order, the particles need not)."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
    rho = a @ a.conj().T
    rho /= np.trace(rho)
    g = ee.init_mixed_ensemble(rho, device="cpu")
    w = jee.init_mixed_ensemble(rho)
    assert g.num_particles == w.num_particles == 8
    _mixture_close(g, w)
    np.testing.assert_allclose(ee.ensemble_mixture(g), rho, atol=TOL)


def test_init_product_ensemble():
    kets = [np.array([1, 1]) / np.sqrt(2), np.array([0.6, 0.8j]),
            np.array([1, 0])]
    g = ee.init_product_ensemble(kets, B=4, device="cpu")
    w = jee.init_product_ensemble(kets, B=4)
    assert g.psi.is_contiguous()
    _same_ensemble(g, w)


def _sigma4(p, B):
    return 4 * np.sqrt(np.maximum(p * (1 - p), 1.0 / B) / B)


def test_measure_sample_distribution():
    """The pre-sampling marginal agrees with the reference's; the sampled
    outcome frequencies lie within 4σ of it; collapsed particles are
    normalised basis states of the targets."""
    n, B = 3, 2000
    got, want = _random_ensemble(n, 4, seed=5)
    # even weights: the frequencies estimate the marginal, and the ESS
    # stays B (no resampling)
    lw = np.full(B, -np.log(B))
    got = ee.QuantumEnsemble(torch.from_numpy(lw),
                             got.psi.repeat_interleave(B // 4, dim=0))
    want = jee.QuantumEnsemble(jnp.asarray(lw),
                               jnp.repeat(want.psi, B // 4, axis=0))
    gen = torch.Generator().manual_seed(0)
    g, gd, outcomes = ee.measure_sample(gen, got, n, [0, 2])
    _, wd, _ = jee.measure_sample(jax.random.PRNGKey(0), want, n, [0, 2])
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=TOL)
    freq = np.bincount(outcomes.numpy(), minlength=4) / B
    assert np.all(np.abs(freq - gd.numpy()) <= _sigma4(gd.numpy(), B))
    assert g.num_particles == B
    np.testing.assert_allclose(
        torch.sum(g.psi.double() ** 2, dim=(1, 2)).numpy(), 1.0, atol=1e-5)


def test_sampled_collapses_match_the_exact_fanout_statistically():
    """discard_sample and replace_sample at B = 4000 against their exact
    fan-outs: every mixture entry within 4σ (entries are means of terms
    bounded by 1, so σ <= 1/√B)."""
    n, B = 3, 4000
    got, _ = _random_ensemble(n, 1, seed=9)
    rep = ee.QuantumEnsemble(got.log_w.repeat(B) - np.log(B),
                             got.psi.repeat(B, 1, 1))
    gen = torch.Generator().manual_seed(1)
    bound = 4 / np.sqrt(B)
    d_exact = ee.discard_fanout(got, n, [1])
    d_samp = ee.discard_sample(gen, rep, n, [1])
    assert np.max(np.abs(ee.ensemble_mixture(d_samp)
                         - ee.ensemble_mixture(d_exact))) <= bound
    ns = _new_states(1, 4, mixed=True)
    r_exact = ee.replace_fanout(got, n, [2], ns)
    r_samp = ee.replace_sample(gen, rep, n, [2], ns)
    assert np.max(np.abs(ee.ensemble_mixture(r_samp)
                         - ee.ensemble_mixture(r_exact))) <= bound
    c_exact = ee.concat_weighted([(0.25, d_exact), (0.75, d_exact)])
    c_samp = ee.concat_resampled(gen, [(0.25, d_samp), (0.75, d_samp)], B)
    assert c_samp.num_particles == B
    assert np.max(np.abs(ee.ensemble_mixture(c_samp)
                         - ee.ensemble_mixture(c_exact))) <= 2 * bound


# ---------------------------------------------------------------------------
# the plain kernels' particle axis
# ---------------------------------------------------------------------------

def _batch(P, n, seed):
    x = np.random.default_rng(seed).normal(size=(P, 2, 2**n))
    return torch.from_numpy(x.astype(np.float32))


def _unitary(d, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return torch.tensor(np.stack([q.real, q.imag]), dtype=torch.float32)


@pytest.mark.parametrize("mode", kernels.DOT_MODES)
@pytest.mark.parametrize("n,start,width", [(5, 0, 5), (5, 1, 3), (8, 0, 7),
                                           (8, 6, 2), (10, 3, 4),
                                           (10, 9, 1)])
def test_plain_window_particle_axis_bit_for_bit(mode, n, start, width):
    psi = _batch(3, n, n + width)
    w = _unitary(2**width, width)
    diag = kernels.fused_diagonals(n, (1, 2**n - 3),
                                   (((0, n - 1), complex(np.exp(0.3j)), 1),))
    got = kernels.window_apply_ref(psi, n, start, width, w, diag, mode)
    for p in range(3):
        one = kernels.window_apply_ref(psi[p].contiguous(), n, start, width,
                                       w, diag, mode)
        assert torch.equal(got[p], one)


@pytest.mark.parametrize("mode", kernels.DOT_MODES)
@pytest.mark.parametrize("n,start,width1,width2",
                         [(5, 0, 2, 3), (5, 1, 1, 2), (9, 0, 2, 7),
                          (10, 2, 3, 3), (10, 6, 2, 2)])
def test_plain_pair_particle_axis_bit_for_bit(mode, n, start, width1,
                                              width2):
    psi = _batch(4, n, n + width1)
    w1, w2 = _unitary(2**width1, 1), _unitary(2**width2, 2)
    diag = kernels.fused_diagonals(n, (3,), (((1,), -1.0 + 0j, 0),))
    got = kernels.pair_apply_ref(psi, n, start, width1, width2, w1, w2,
                                 diag, mode)
    for p in range(4):
        one = kernels.pair_apply_ref(psi[p].contiguous(), n, start, width1,
                                     width2, w1, w2, diag, mode)
        assert torch.equal(got[p], one)


@pytest.mark.parametrize("H,T", [(2, 2), (4, 8), (64, 128)])
def test_plain_reflections_particle_axis_bit_for_bit(H, T):
    rng = np.random.default_rng(H)
    psi = torch.from_numpy(rng.normal(size=(3, 2, H, T)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(2, H, 1)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 1, T)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32))
    flips = torch.tensor([1, H * T - 1], dtype=torch.int64)
    d = kernels.reflect_dot(psi, a, b)
    out, d2 = kernels.reflect_update(psi, c, a, b, flips)
    assert d.shape == (3, 2, 1, T) and out.shape == psi.shape
    for p in range(3):
        assert torch.equal(d[p], kernels.reflect_dot_ref(psi[p], a, b))
        o1, e1 = kernels.reflect_update_ref(psi[p], c[p], a, b, flips)
        assert torch.equal(out[p], o1) and torch.equal(d2[p], e1)


def test_wrappers_refuse_a_batch_of_the_wrong_shape():
    psi = torch.zeros((2, 3, 2, 16))
    w = _unitary(2, 0)
    with pytest.raises(ValueError, match="batch"):
        kernels.window_apply(psi, 4, 0, 1, w, kernels.fused_diagonals(4))


# ---------------------------------------------------------------------------
# the initial planar state kept on the LoweredProgram
# ---------------------------------------------------------------------------

PREP = "qset tensorExp(hadamard.kets[0], 10)"
ONLY_MEAS = PREP + "\nmeas a ; computation ; [0]"
ONLY_PEEK = PREP + "\npeek a ; computation ; [0]"


def _lowered(text=None):
    if text is None:
        rng = np.random.default_rng(5)
        text, _ = smc_program(10, iter(rng.uniform(0.8, 2.3, size=40)))
    return lowering.lower_program(text, mid_measure=True)


def _run(lp, sample, seed=3):
    res, ens = lowering.run_lowered_ensemble(lp, window=7, sample=sample,
                                             seed=seed, device="cpu")
    return {k: np.asarray(v.probs) for k, v in res.items()}, ens


def _kept(lp):
    return lp._init_planar[2]


@pytest.mark.parametrize("sample", [0, 16])
def test_runs_on_the_kept_initial_state_repeat_bit_for_bit(sample):
    """Two runs of one program from one seed, and a run of the program
    lowered anew: equal readouts, log-weights and states, bit for bit."""
    lp = _lowered()
    runs = [_run(lp, sample), _run(lp, sample), _run(_lowered(), sample)]
    (r0, e0) = runs[0]
    for r, e in runs[1:]:
        assert r.keys() == r0.keys()
        for k in r0:
            np.testing.assert_array_equal(r[k], r0[k])
        assert torch.equal(e.log_w, e0.log_w)
        assert torch.equal(e.psi, e0.psi)


@pytest.mark.parametrize("text,sample", [
    (None, 0), (None, 16), (None, 1), (ONLY_MEAS, 0), (ONLY_MEAS, 1),
    (ONLY_PEEK, 0), (PREP, 0), (PREP, 4)],
    ids=["exact", "sampled", "one-particle", "only-meas-exact",
         "only-meas-one-particle", "only-peek", "no-ops", "no-ops-sampled"])
def test_kept_initial_state_is_never_written(text, sample):
    """The kept state equals the state a fresh build gives after every
    run, also when the caller writes into the final ensemble, and no final
    ensemble shares its storage (a program without gates or collapses
    returns the ensemble that init made)."""
    lp = _lowered(text)
    want = product_state_planar(lp.initial_kets, "cpu")
    for _ in range(2):
        _, ens = _run(lp, sample)
        kept = _kept(lp)
        assert (ens.psi.untyped_storage().data_ptr()
                != kept.untyped_storage().data_ptr())
        ens.psi.add_(1.0)
        assert torch.equal(kept, want)


def test_two_runs_count_one_build_and_one_reuse():
    lp = _lowered()
    before = profiling.counters()
    _run(lp, 16)
    _run(lp, 0)
    after = profiling.counters()
    got = {k: after.get(k, 0) - before.get(k, 0)
           for k in ("init_state_builds", "init_state_reuses")}
    assert got == {"init_state_builds": 1, "init_state_reuses": 1}


def test_rebound_kets_or_another_device_build_the_state_anew():
    """Rebinding ``initial_kets`` or one of its arrays builds the state
    anew; so does another device ("meta" stands for a second device on a
    machine without a card), and the one kept is the newest device's."""
    lp = _lowered()
    cpu = torch.device("cpu")

    def builds(device=cpu):
        before = profiling.counters().get("init_state_builds", 0)
        psi0 = lowering._initial_planar(lp, device)
        return profiling.counters()["init_state_builds"] - before, psi0

    assert builds()[0] == 1
    n, first = builds()
    assert n == 0 and first is _kept(lp)
    lp.initial_kets = list(lp.initial_kets)
    n, psi0 = builds()
    assert n == 1 and psi0 is not first and torch.equal(psi0, first)
    lp.initial_kets[0] = lp.initial_kets[0].copy()
    assert builds()[0] == 1
    n, meta = builds(torch.device("meta"))
    assert n == 1 and meta.device.type == "meta"
    assert builds()[0] == 1 and builds()[0] == 0
    _run(lp, 4)
    assert builds()[0] == 0
