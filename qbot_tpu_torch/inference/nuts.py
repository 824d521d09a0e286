"""No-U-Turn sampler over continuous gate parameters (iterative).

Port of :mod:`qbot_tpu.inference.nuts`, the iterative formulation of
NUTS with

* multiplicative trajectory doubling to ``max_tree_depth``,
* multinomial leaf sampling with biased progressive updates
  (Betancourt 2017) instead of the original slice sampler,
* sub-tree U-turn detection via a checkpoint stack of
  ``max_tree_depth + 1`` saved states: even-indexed leaf ``a`` is stored at
  slot ``popcount(a)``; arriving at leaf ``i``, every complete subtree
  ``[i+1-2^k, i]`` is checked against its stored left edge.

Leapfrog with ``±eps`` keeps all momenta in the forward time frame, so the
Hoffman–Gelman turning criterion ``⟨q⁺−q⁻, r⁻⟩<0 ∨ ⟨q⁺−q⁻, r⁺⟩<0`` applies
directly with ``delta = v·(q_new − q_stored)``.

The reference's ``lax.while_loop``s become Python loops that read
``turning`` and ``diverged`` on the host after every leaf.  At the sizes
this serves a leaf is a full value-and-gradient of the circuit (at 24
qubits tens of kernel launches each way), so that one synchronisation a
leaf costs nothing worth measuring.  Draws come from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from qbot_tpu_torch.inference.hmc import (
    HMCState,
    _dual_average,
    _normal,
    _uniform,
    chain_generators,
    hmc_init,
    value_and_grad,
)

__all__ = ["NutsStats", "nuts_step", "run_nuts", "run_nuts_chains",
           "nuts_warmup"]

_DIVERGENCE = 1000.0


class NutsStats(NamedTuple):
    accept_prob: torch.Tensor   # averaged Metropolis prob over visited leaves
    num_leaves: torch.Tensor    # leapfrog steps taken this transition
    depth: torch.Tensor         # tree depth reached
    diverged: torch.Tensor
    turned: torch.Tensor


class _Subtree(NamedTuple):
    q: torch.Tensor             # end point of the subtree's trajectory
    r: torch.Tensor
    grad: torch.Tensor
    q_prop: torch.Tensor        # its multinomial proposal
    lp_prop: torch.Tensor
    grad_prop: torch.Tensor
    log_sum_w: float            # logsumexp of its leaf weights (energies)
    turning: bool
    diverged: bool
    sum_accept: float
    num_leaves: int


def _leapfrog(lp_and_grad, q, r, grad, eps):
    r = r + 0.5 * eps * grad
    q = q + eps * r
    lp, grad = lp_and_grad(q)
    r = r + 0.5 * eps * grad
    return q, r, grad, lp


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _is_turning(delta, r_a, r_b) -> bool:
    return bool((torch.dot(delta, r_a) < 0.0) | (torch.dot(delta, r_b) < 0.0))


def _logaddexp(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def _build_subtree(lp_and_grad, q0, r0, grad0, v_eps: float,
                   num_leaves: int, max_depth: int, energy0: float,
                   gen: torch.Generator) -> _Subtree:
    """Integrate up to ``num_leaves`` leapfrog steps from (q0, r0), tracking
    the subtree's multinomial proposal, weight, and internal U-turns; stop
    early at a U-turn or a divergence."""
    sign = math.copysign(1.0, v_eps)
    ckpt_q = [None] * (max_depth + 1)
    ckpt_r = [None] * (max_depth + 1)
    q, r, grad = q0, r0, grad0
    # the first leaf always replaces the proposal (lsw starts at -inf)
    qp, lpp, gp = q0, None, grad0
    lsw, turning, diverged, s_acc, i = -math.inf, False, False, 0.0, 0
    while i < num_leaves and not turning and not diverged:
        q, r, grad, lp = _leapfrog(lp_and_grad, q, r, grad, v_eps)
        energy = float(lp - 0.5 * torch.dot(r, r))
        diverged = (energy0 - energy) > _DIVERGENCE
        # biased multinomial proposal update within the subtree
        new_lsw = _logaddexp(lsw, energy)
        if math.log(float(_uniform(gen, "cpu"))) < energy - new_lsw:
            qp, lpp, gp = q, lp, grad
        lsw = new_lsw
        s_acc += min(1.0, math.exp(min(energy - energy0, 0.0)))
        if i % 2 == 0:             # checkpoint even leaves at popcount(i)
            ckpt_q[_popcount(i)] = q
            ckpt_r[_popcount(i)] = r
        # every complete subtree [i + 1 - 2^k, i] ending at leaf i
        for k in range(1, max_depth + 1):
            size = 1 << k
            if (i + 1) % size:
                continue
            slot = _popcount(i + 1 - size)
            delta = (q - ckpt_q[slot]) * sign
            turning = turning or _is_turning(delta, ckpt_r[slot], r)
        i += 1
    return _Subtree(q, r, grad, qp, lpp, gp, lsw, turning, diverged, s_acc,
                    i)


def nuts_step(gen: torch.Generator, state: HMCState, log_prob: Callable,
              step_size: float, max_tree_depth: int = 8
              ) -> tuple[HMCState, NutsStats]:
    """One No-U-Turn transition, its draws from ``gen``."""
    lp_and_grad = value_and_grad(log_prob)
    eps = float(step_size)
    r0 = _normal(gen, state.position)
    energy0 = float(state.log_prob - 0.5 * torch.dot(r0, r0))

    left = right = (state.position, r0, state.grad)
    q_prop, lp_prop, grad_prop = state.position, state.log_prob, state.grad
    log_sum_w = 0.0                 # leaf-0 weight relative to energy0
    depth, turning, diverged = 0, False, False
    sum_accept, num_leaves = 0.0, 0
    while depth < max_tree_depth and not turning and not diverged:
        go_right = float(_uniform(gen, "cpu")) < 0.5
        start = right if go_right else left
        sub = _build_subtree(lp_and_grad, *start,
                             eps if go_right else -eps, 1 << depth,
                             max_tree_depth, energy0, gen)
        # subtree leaf weights are energies relative to energy0
        lsw = sub.log_sum_w - energy0
        bad = sub.turning or sub.diverged
        # biased progressive sampling across the doubling
        take = math.log(float(_uniform(gen, "cpu"))) < lsw - log_sum_w
        if take and not bad:
            q_prop, lp_prop, grad_prop = sub.q_prop, sub.lp_prop, \
                sub.grad_prop
        if not bad:
            end = (sub.q, sub.r, sub.grad)
            if go_right:
                right = end
            else:
                left = end
            log_sum_w = _logaddexp(log_sum_w, lsw)
        full_turn = _is_turning(right[0] - left[0], left[1], right[1])
        depth += 1
        turning = turning or sub.turning or full_turn
        diverged = diverged or sub.diverged
        sum_accept += sub.sum_accept
        num_leaves += sub.num_leaves

    device = state.position.device
    stats = NutsStats(
        accept_prob=torch.tensor(sum_accept / max(num_leaves, 1),
                                 device=device),
        num_leaves=torch.tensor(num_leaves, device=device),
        depth=torch.tensor(depth, device=device),
        diverged=torch.tensor(diverged, device=device),
        turned=torch.tensor(turning, device=device))
    return HMCState(q_prop, lp_prop, grad_prop), stats


def _stack_stats(stats: list) -> NutsStats:
    return NutsStats(*(torch.stack(field) for field in zip(*stats)))


def run_nuts(gen: torch.Generator, log_prob: Callable, theta0: torch.Tensor,
             num_samples: int, step_size: float = 0.1,
             max_tree_depth: int = 8):
    """Single-chain NUTS; returns (positions, log_probs, stats), each
    stacked over the samples."""
    state = hmc_init(log_prob, theta0)
    qs, lps, stats = [], [], []
    for _ in range(num_samples):
        state, st = nuts_step(gen, state, log_prob, step_size,
                              max_tree_depth)
        qs.append(state.position)
        lps.append(state.log_prob)
        stats.append(st)
    return torch.stack(qs), torch.stack(lps), _stack_stats(stats)


def run_nuts_chains(gen: torch.Generator, log_prob: Callable,
                    theta0: torch.Tensor, num_samples: int,
                    step_size: float = 0.1, max_tree_depth: int = 8):
    """Multi-chain NUTS; ``theta0``: (chains, dim).  Each chain draws from
    its own generator (:func:`qbot_tpu_torch.inference.hmc.chain_generators`);
    returns positions (chains, S, dim), log_probs (chains, S) and stats
    stacked (chains, S)."""
    gens = chain_generators(gen, theta0.shape[0])
    runs = [run_nuts(g, log_prob, t0, num_samples, step_size,
                     max_tree_depth) for g, t0 in zip(gens, theta0)]
    return (torch.stack([q for q, _, _ in runs]),
            torch.stack([lp for _, lp, _ in runs]),
            _stack_stats([st for _, _, st in runs]))


def nuts_warmup(gen: torch.Generator, log_prob: Callable,
                theta0: torch.Tensor, num_warmup: int = 100,
                target_accept: float = 0.8, init_step_size: float = 0.1,
                max_tree_depth: int = 8):
    """Dual-averaging step-size adaptation driving full NUTS transitions.

    Returns (adapted step size as a float, warmed state).
    """
    state = hmc_init(log_prob, theta0)
    mu = math.log(10.0 * init_step_size)
    log_eps = log_eps_avg = math.log(init_step_size)
    t = h_avg = 0.0
    for _ in range(num_warmup):
        state, stats = nuts_step(gen, state, log_prob, math.exp(log_eps),
                                 max_tree_depth)
        t, h_avg, log_eps, log_eps_avg = _dual_average(
            t, h_avg, log_eps_avg, mu, float(stats.accept_prob),
            target_accept)
    return math.exp(log_eps_avg), state
