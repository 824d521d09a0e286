"""HMC over continuous gate parameters.

Port of :mod:`qbot_tpu.inference.hmc`: gate angles are the leaves of a
log-probability ``θ → log p(observed | circuit(θ))`` built from a compiled
parameterised plan, and Hamiltonian Monte Carlo samples it.  Value and
gradient come from ``torch.autograd.grad``; through the planar log-prob
the gradient runs the window, pair and reflection kernels' backward
(:mod:`qbot_tpu_torch.tpu.kernels`), so on a CUDA device every pass of a
leapfrog step, forward and backward, is a hand-written kernel.

Randomness comes from ``torch.Generator``s in place of the reference's
keys, so a chain does not repeat the reference's draws from the same seed.
The reference's ``lax.fori_loop`` / ``lax.scan`` / ``vmap`` become Python
loops: PyTorch runs eagerly, and a value-and-gradient at the sizes this
serves (24 qubits: a 128 MiB state, a few dozen kernel launches each way)
dwarfs the loop's host work.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from qbot_tpu_torch.tpu import simulator
from qbot_tpu_torch.tpu.compiler import Plan
from qbot_tpu_torch.tpu.planar import (
    make_planar_runner,
    planar_probs,
    zero_state_planar,
)

__all__ = ["make_circuit_log_prob", "make_circuit_log_prob_planar",
           "HMCState", "hmc_init", "hmc_step", "run_hmc", "run_hmc_chains",
           "dual_averaging_warmup", "value_and_grad"]


def _posterior(probs_of: Callable, observed_counts, prior_sigma: float,
               device, dtype) -> Callable:
    """log p(θ | counts) = Σ counts·log clamp(p(θ), 1e-12, 1) (multinomial)
    − ½‖θ/σ‖² (isotropic normal prior), with θ moved to ``device``."""
    device = torch.device(device)
    counts = torch.as_tensor(np.asarray(observed_counts), dtype=dtype,
                             device=device)

    def log_prob(theta):
        theta = theta.to(device)
        p = torch.clamp(probs_of(theta), 1e-12, 1.0)
        loglik = torch.sum(counts * torch.log(p))
        logprior = -0.5 * torch.sum((theta / prior_sigma) ** 2)
        return loglik + logprior

    return log_prob


def make_circuit_log_prob(plan: Plan, observed_counts, targets=None,
                          prior_sigma: float = 10.0,
                          dtype=torch.complex64, device="cuda") -> Callable:
    """Posterior log-density over gate angles given measurement counts,
    through the complex simulator (plain PyTorch, the dense oracle).

    ``observed_counts``: (K,) counts over computation-basis outcomes of
    ``targets`` (all qubits if None).  Likelihood = multinomial; prior =
    isotropic normal on angles.  The state lives on ``device``.
    """
    run = simulator.make_statevector_runner(plan)
    device = torch.device(device)
    real = torch.float64 if dtype == torch.complex128 else torch.float32

    def probs_of(theta):
        psi = run(simulator.zero_state(plan.n, dtype, device), theta)
        return simulator.computation_probs(psi, targets, plan.n)

    return _posterior(probs_of, observed_counts, prior_sigma, device, real)


def make_circuit_log_prob_planar(plan: Plan, observed_counts, targets=None,
                                 prior_sigma: float = 10.0,
                                 device="cuda") -> Callable:
    """Planar float32 twin of :func:`make_circuit_log_prob`: the same
    posterior through :func:`qbot_tpu_torch.tpu.planar.make_planar_runner`
    (static steps prepared once, parameterised windows folded per call),
    its gradient through the kernels' backward on a CUDA device, so the
    default paired plan is differentiated on the tuned forward path."""
    run = make_planar_runner(plan)
    device = torch.device(device)

    def probs_of(theta):
        psi = run(zero_state_planar(plan.n, device), theta)
        return planar_probs(psi, targets, plan.n)

    return _posterior(probs_of, observed_counts, prior_sigma, device,
                      torch.float32)


def value_and_grad(log_prob: Callable) -> Callable:
    """``theta -> (log_prob(theta), ∇log_prob(theta))``, both detached."""
    def vg(theta):
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = log_prob(theta)
            (grad,) = torch.autograd.grad(lp, theta)
        return lp.detach(), grad
    return vg


class HMCState(NamedTuple):
    position: torch.Tensor
    log_prob: torch.Tensor
    grad: torch.Tensor


def hmc_init(log_prob: Callable, theta0: torch.Tensor) -> HMCState:
    lp, g = value_and_grad(log_prob)(theta0)
    return HMCState(theta0, lp, g)


def _normal(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=gen, device=gen.device,
                       dtype=like.dtype).to(like.device)


def _uniform(gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand((), generator=gen, device=gen.device).to(device)


def _leapfrog(log_prob_grad, q, p, grad, eps: float, steps: int):
    """``steps`` leapfrog steps from (q, p) with ∇ at q ``grad``; returns
    (q, p, grad, log_prob at q).  The reference evaluates the end point
    once more; the log-prob of the last step's evaluation is returned
    instead."""
    lp = None
    for _ in range(steps):
        p = p + 0.5 * eps * grad
        q = q + eps * p
        lp, grad = log_prob_grad(q)
        p = p + 0.5 * eps * grad
    if lp is None:
        lp, grad = log_prob_grad(q)
    return q, p, grad, lp


def _transition(gen, state: HMCState, vg, eps: float, num_leapfrog: int):
    """(next state, Metropolis acceptance probability) of one HMC
    transition."""
    p0 = _normal(gen, state.position)
    q, p, grad, new_lp = _leapfrog(vg, state.position, p0, state.grad, eps,
                                   num_leapfrog)
    ham0 = state.log_prob - 0.5 * torch.sum(p0**2)
    ham1 = new_lp - 0.5 * torch.sum(p**2)
    accept = torch.log(_uniform(gen, q.device)) < (ham1 - ham0)
    new = HMCState(torch.where(accept, q, state.position),
                   torch.where(accept, new_lp, state.log_prob),
                   torch.where(accept, grad, state.grad))
    return new, torch.clamp(torch.exp(ham1 - ham0), max=1.0)


def hmc_step(gen: torch.Generator, state: HMCState, log_prob: Callable,
             step_size: float = 0.1, num_leapfrog: int = 10) -> HMCState:
    """One Metropolis-adjusted HMC transition, its draws from ``gen``."""
    return _transition(gen, state, value_and_grad(log_prob), step_size,
                       num_leapfrog)[0]


def run_hmc(gen: torch.Generator, log_prob: Callable, theta0: torch.Tensor,
            num_samples: int, step_size: float = 0.1,
            num_leapfrog: int = 10):
    """Single-chain HMC; returns (positions (S, dim), log_probs (S,))."""
    state = hmc_init(log_prob, theta0)
    qs, lps = [], []
    for _ in range(num_samples):
        state = hmc_step(gen, state, log_prob, step_size, num_leapfrog)
        qs.append(state.position)
        lps.append(state.log_prob)
    return torch.stack(qs), torch.stack(lps)


def chain_generators(gen: torch.Generator, chains: int) -> list:
    """One generator a chain, on ``gen``'s device, each seeded by one draw
    of ``gen`` (63-bit seeds, drawn in chain order), so a run is a function
    of the caller's generator state."""
    seeds = torch.randint(0, 2**62, (chains,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s) for s in seeds]


def run_hmc_chains(gen: torch.Generator, log_prob: Callable,
                   theta0: torch.Tensor, num_samples: int,
                   step_size: float = 0.1, num_leapfrog: int = 10):
    """Multi-chain HMC; ``theta0``: (chains, dim).  Returns positions
    (chains, S, dim) and log_probs (chains, S).

    Each chain draws from its own generator (:func:`chain_generators`) and
    runs its log-prob as launches of its own: the kernels take one W for a
    whole particle batch, and chains differ in θ.
    """
    gens = chain_generators(gen, theta0.shape[0])
    runs = [run_hmc(g, log_prob, t0, num_samples, step_size, num_leapfrog)
            for g, t0 in zip(gens, theta0)]
    return (torch.stack([q for q, _ in runs]),
            torch.stack([lp for _, lp in runs]))


def _dual_average(t: float, h_avg: float, log_eps_avg: float, mu: float,
                  accept_prob: float, target_accept: float):
    """One Nesterov dual-averaging update (Hoffman & Gelman 2014, alg. 5
    constants): returns (t, h_avg, log_eps, log_eps_avg)."""
    t = t + 1.0
    h_avg = ((1 - 1 / (t + 10)) * h_avg
             + (target_accept - accept_prob) / (t + 10))
    log_eps = mu - math.sqrt(t) / 0.05 * h_avg
    w = t ** -0.75
    return t, h_avg, log_eps, w * log_eps + (1 - w) * log_eps_avg


def dual_averaging_warmup(gen: torch.Generator, log_prob: Callable,
                          theta0: torch.Tensor, num_warmup: int = 100,
                          target_accept: float = 0.8,
                          init_step_size: float = 0.1,
                          num_leapfrog: int = 10):
    """Nesterov dual-averaging step-size adaptation (NUTS-style warmup).

    Returns (adapted step size as a float, warmed state); the acceptance
    statistic is the expected Metropolis ratio of each transition, read on
    the host once a transition.
    """
    vg = value_and_grad(log_prob)
    mu = math.log(10.0 * init_step_size)
    state = hmc_init(log_prob, theta0)
    log_eps = log_eps_avg = math.log(init_step_size)
    t = h_avg = 0.0
    for _ in range(num_warmup):
        state, accept_prob = _transition(gen, state, vg, math.exp(log_eps),
                                         num_leapfrog)
        t, h_avg, log_eps, log_eps_avg = _dual_average(
            t, h_avg, log_eps_avg, mu, float(accept_prob), target_accept)
    return math.exp(log_eps_avg), state
