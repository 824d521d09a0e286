"""The port's SMC particle ensembles (``qbot_tpu_torch/inference/smc.py``)
against ``qbot_tpu.inference.smc``, on the CPU.

Inputs come from one numpy seed and go to both packages.  The reference
draws its resampling uniform from a JAX key; the port splits that draw off
(``systematic_indices``), so each test draws the uniform with JAX and hands
it to the port: the indices agree index for index.  Tolerance: 1e-12 on
float64 weights and densities (the same float64 arithmetic, summed in
another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qbot_tpu.inference import smc as jsmc
from qbot_tpu_torch.inference import smc

torch.set_num_threads(1)

TOL = 1e-12


def _log_weights(B, seed, spread=3.0):
    return np.random.default_rng(seed).normal(size=B) * spread


def _both(log_w, values):
    return (smc.Ensemble(torch.from_numpy(log_w), torch.from_numpy(values)),
            jsmc.Ensemble(jnp.asarray(log_w), jnp.asarray(values)))


@pytest.mark.parametrize("seed", range(3))
def test_normalize_and_ess(seed):
    lw = _log_weights(16, seed)
    got, want = _both(lw, np.arange(16.0))
    np.testing.assert_allclose(smc.normalize(got.log_weights).numpy(),
                               np.asarray(jsmc.normalize(want.log_weights)),
                               atol=TOL)
    np.testing.assert_allclose(
        float(smc.effective_sample_size(got.log_weights)),
        float(jsmc.effective_sample_size(want.log_weights)), rtol=1e-12)
    np.testing.assert_allclose(got.weights().numpy(),
                               np.asarray(want.weights()), atol=TOL)
    assert got.num_particles == want.num_particles == 16


@pytest.mark.parametrize("B,seed", [(8, 0), (64, 1), (200, 2), (5, 3)])
def test_systematic_resample_indices_match_for_the_same_uniform(B, seed):
    """Values arange(B): the resampled values are the indices."""
    lw = _log_weights(B, seed)
    key = jax.random.PRNGKey(seed)
    want = jsmc.systematic_resample(key, jsmc.Ensemble(
        jnp.asarray(lw), jnp.arange(B)))
    u0 = float(jax.random.uniform(key, ()))
    w = smc.Ensemble(torch.from_numpy(lw), None).weights()
    idx = smc.systematic_indices(w, u0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want.values))
    np.testing.assert_allclose(np.asarray(want.log_weights), -np.log(B))


def test_systematic_resample_draws_its_uniform_from_the_generator():
    lw = _log_weights(32, 4)
    ens = smc.Ensemble(torch.from_numpy(lw), (torch.arange(32),
                                              torch.arange(32) * 2))
    gen = torch.Generator().manual_seed(11)
    u0 = torch.rand((), generator=torch.Generator().manual_seed(11),
                    dtype=torch.float64)
    out = smc.systematic_resample(gen, ens)
    idx = smc.systematic_indices(ens.weights(), u0)
    assert torch.equal(out.values[0], idx)
    assert torch.equal(out.values[1], idx * 2)
    np.testing.assert_allclose(out.log_weights.numpy(), -np.log(32))


@pytest.mark.parametrize("spread", [0.01, 5.0])
def test_resample_if_needed(spread):
    """Even weights (ESS near B) are only normalised, as the reference's;
    uneven ones resample with the generator's uniform."""
    lw = _log_weights(64, 5, spread)
    got, want = _both(lw, np.arange(64.0))
    key = jax.random.PRNGKey(2)
    ref = jsmc.resample_if_needed(key, want)
    out = smc.resample_if_needed(torch.Generator().manual_seed(3), got)
    if spread < 1:
        np.testing.assert_allclose(out.log_weights.numpy(),
                                   np.asarray(ref.log_weights), atol=TOL)
        np.testing.assert_array_equal(out.values.numpy(),
                                      np.asarray(ref.values))
    else:
        u0 = torch.rand((), generator=torch.Generator().manual_seed(3),
                        dtype=torch.float64)
        idx = smc.systematic_indices(got.weights(), u0)
        np.testing.assert_array_equal(out.values.numpy(), idx.numpy())
        np.testing.assert_allclose(out.log_weights.numpy(),
                                   np.asarray(ref.log_weights), atol=TOL)


def test_branch_and_from_probs():
    rng = np.random.default_rng(6)
    lw = _log_weights(4, 6)
    blp = np.log(rng.dirichlet(np.ones(3), size=4))
    vals = rng.normal(size=(4, 3, 2))
    got = smc.branch(smc.Ensemble(torch.from_numpy(lw), None),
                     torch.from_numpy(blp), torch.from_numpy(vals))
    want = jsmc.branch(jsmc.Ensemble(jnp.asarray(lw), None),
                       jnp.asarray(blp), jnp.asarray(vals))
    np.testing.assert_allclose(got.log_weights.numpy(),
                               np.asarray(want.log_weights), atol=TOL)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    p = rng.dirichlet(np.ones(5))
    np.testing.assert_allclose(
        smc.from_probs(p, None).log_weights.numpy(),
        np.asarray(jsmc.from_probs(p, None).log_weights), atol=TOL)


def test_mix_to_density():
    rng = np.random.default_rng(7)
    kets = rng.normal(size=(6, 8)) + 1j * rng.normal(size=(6, 8))
    kets /= np.linalg.norm(kets, axis=1, keepdims=True)
    lw = _log_weights(6, 7)
    got = smc.mix_to_density(smc.Ensemble(torch.from_numpy(lw), None),
                             torch.from_numpy(kets))
    want = jsmc.mix_to_density(jsmc.Ensemble(jnp.asarray(lw), None),
                               jnp.asarray(kets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_lift_vmap():
    lw = _log_weights(5, 8)
    vals = np.random.default_rng(8).normal(size=(5, 3))
    got, want = _both(lw, vals)
    out = smc.lift_vmap(lambda v, s: torch.sum(v * v) * s, got, 2.0)
    ref = jsmc.lift_vmap(lambda v, s: jnp.sum(v * v) * s, want, 2.0)
    np.testing.assert_allclose(out.values.numpy(), np.asarray(ref.values),
                               rtol=1e-12)


@pytest.mark.parametrize("tupled", [False, True])
def test_to_probval(tupled):
    lw = np.log(np.array([0.2, 0.3, 0.5]))
    vals = np.array([1, 2, 3])
    got, want = _both(lw, vals)
    if tupled:
        got = smc.Ensemble(got.log_weights, (got.values, got.values * 10))
        want = jsmc.Ensemble(want.log_weights, (want.values,
                                                want.values * 10))
    pg, pw = smc.to_probval(got), jsmc.to_probval(want)
    np.testing.assert_allclose(pg.probs, pw.probs, atol=TOL)
    assert [np.asarray(v).tolist() for v in pg.values] == \
        [np.asarray(v).tolist() for v in pw.values]
