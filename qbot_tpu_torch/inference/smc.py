"""Sequential-Monte-Carlo particle ensembles: the device-side ProbVal.

Port of :mod:`qbot_tpu.inference.smc` (``qbot_tpu/inference/smc.py``).  The
host-side :class:`~qbot_tpu_torch.probval.ProbVal` keeps exact branch lists;
this module is its scalable twin, a **weighted particle ensemble** with

* ``log_weights``: (B,) float tensor, the branch-probability axis,
* ``values``: a tensor, or a tuple or list of them (nested freely), whose
  leaves carry a leading (B,) batch axis.

ProbVal's cartesian-product lifting becomes a batch dimension (``lift`` maps
a function over it with ``torch.func.vmap``); normalisation becomes
log-weight normalisation; pruning becomes resampling.

Randomness comes from an explicit :class:`torch.Generator` on the
ensemble's device, not from JAX keys: the two give other numbers from one
seed, so sampled runs do not repeat the reference's.  Systematic
resampling is split so that its indices are a function of its one uniform
draw ``u0`` (:func:`systematic_indices`): both packages give the same
indices for the same ``u0``.

On the particle × qubit mesh (:mod:`qbot_tpu_torch.tpu.sharded_ensemble`)
the batch axis is split over the P rows of particles: :func:`normalize`
reduces over the particle axis when given it (the reference's
``axis_name``, an ``all_reduce`` over the ranks' group), and
:func:`island_indices` is the island-local systematic resampling of a row,
each row resampling within itself and keeping its total weight.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Ensemble", "from_probs", "normalize", "effective_sample_size",
           "systematic_indices", "systematic_resample", "island_indices",
           "resample_if_needed", "lift_vmap", "mix_to_density", "branch",
           "to_probval"]

_MIN_P = 1e-12


def tree_map(fn: Callable, values):
    """``fn`` on every tensor leaf of ``values`` (a tensor, or a tuple or
    list of them), keeping the structure."""
    if isinstance(values, (tuple, list)):
        return type(values)(tree_map(fn, v) for v in values)
    return fn(values)


def tree_leaves(values) -> list:
    if isinstance(values, (tuple, list)):
        return [leaf for v in values for leaf in tree_leaves(v)]
    return [values]


class Ensemble(NamedTuple):
    """Weighted particle ensemble."""
    log_weights: torch.Tensor       # (B,)
    values: object                  # tensor or tuple/list of them, (B, ...)

    @property
    def num_particles(self) -> int:
        return self.log_weights.shape[0]

    def weights(self) -> torch.Tensor:
        return torch.exp(normalize(self.log_weights))


def from_probs(probs, values) -> Ensemble:
    return Ensemble(torch.log(torch.as_tensor(probs)), values)


def normalize(log_weights: torch.Tensor, axis=None) -> torch.Tensor:
    """Log-normalised weights: log w − logsumexp(log w).  With ``axis``
    (the particle axis of a mesh: a group of ranks with ``group`` and
    ``size``, each holding a block of the batch), the sum runs over every
    rank's block, one ``all_reduce``."""
    local = torch.logsumexp(log_weights, dim=0)
    if axis is None:
        return log_weights - local
    total = torch.exp(local)
    if axis.size > 1:
        dist.all_reduce(total, group=axis.group)
    return log_weights - torch.log(total)


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / Σ wᵢ² of the normalised weights."""
    lw = normalize(log_weights)
    return 1.0 / torch.exp(torch.logsumexp(2.0 * lw, dim=0))


def systematic_indices(weights: torch.Tensor, u0,
                       count: int | None = None) -> torch.Tensor:
    """Indices of systematic resampling at the uniform draw ``u0`` in
    [0, 1): the points (u0 + k)/B, k < B, looked up in the cumulative
    weights (left side, as ``jnp.searchsorted``), as the reference forms
    them (``u0 / B + k / B``).  ``count`` draws that many points (B by
    default), each index below the number of weights."""
    B = weights.shape[0] if count is None else count
    cum = torch.cumsum(weights, dim=0)
    k = torch.arange(B, dtype=weights.dtype, device=weights.device)
    points = torch.as_tensor(u0, dtype=weights.dtype,
                             device=weights.device) / B + k / B
    idx = torch.searchsorted(cum, points)
    return torch.clamp(idx, 0, weights.shape[0] - 1)


def island_indices(log_weights: torch.Tensor, u0, count: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Island-local systematic resampling of one row of particles (the
    reference's ``_island_resample`` and ``resample_down_sharded``,
    ``qbot_tpu/tpu/sharded_ensemble.py:863-887, 1253-1293``): (the
    :func:`systematic_indices` of the row's own normalised weights at
    ``u0``, ``count`` of them; the row's log total weight, which each
    survivor shares equally, log total − log count)."""
    m = torch.max(log_weights)
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(log_weights - safe)
    total = torch.sum(w)
    idx = systematic_indices(w / torch.clamp(total, min=_MIN_P), u0, count)
    return idx, safe + torch.log(torch.clamp(total, min=_MIN_P))


def systematic_resample(gen: torch.Generator,
                        ensemble: Ensemble) -> Ensemble:
    """Systematic resampling: low variance, one uniform draw from ``gen``."""
    B = ensemble.num_particles
    w = ensemble.weights()
    u0 = torch.rand((), generator=gen, dtype=w.dtype, device=gen.device)
    idx = systematic_indices(w, u0.to(w.device))
    values = tree_map(lambda v: v[idx], ensemble.values)
    lw = torch.zeros(B, dtype=ensemble.log_weights.dtype,
                     device=ensemble.log_weights.device) - np.log(B)
    return Ensemble(lw, values)


def resample_if_needed(gen: torch.Generator, ensemble: Ensemble,
                       threshold: float = 0.5) -> Ensemble:
    """Resample when ESS drops below threshold·B, else normalise."""
    ess = effective_sample_size(ensemble.log_weights)
    if float(ess) < threshold * ensemble.num_particles:
        return systematic_resample(gen, ensemble)
    return Ensemble(normalize(ensemble.log_weights), ensemble.values)


def lift_vmap(func: Callable, ensemble: Ensemble, *args) -> Ensemble:
    """Map ``func`` over every particle (``torch.func.vmap``)."""
    out = torch.func.vmap(lambda v: func(v, *args))(ensemble.values)
    return Ensemble(ensemble.log_weights, out)


def branch(ensemble: Ensemble, branch_log_probs: torch.Tensor,
           branch_values) -> Ensemble:
    """Fan every particle out over K outcomes (measurement / ProbVal spawn).

    ``branch_log_probs``: (B, K) per-particle outcome log-probabilities;
    ``branch_values``: leaves (B, K, ...).  Returns a B·K ensemble, the
    static-shape analogue of ProbVal's cartesian product.
    """
    B, K = branch_log_probs.shape
    lw = (ensemble.log_weights[:, None] + branch_log_probs).reshape(B * K)
    values = tree_map(lambda v: v.reshape((B * K,) + tuple(v.shape[2:])),
                      branch_values)
    return Ensemble(lw, values)


def mix_to_density(ensemble: Ensemble, kets: torch.Tensor) -> torch.Tensor:
    """Σ wᵢ |ψᵢ⟩⟨ψᵢ|: fold a pure-state ensemble to one density matrix."""
    w = ensemble.weights().to(kets.dtype)
    return torch.einsum("b,bi,bj->ij", w, kets, torch.conj(kets))


def to_probval(ensemble: Ensemble):
    """Collapse a small ensemble back to an exact host-side ProbVal."""
    from qbot_tpu_torch.probval import ProbVal

    w = ensemble.weights().cpu().numpy()
    vals = [leaf.detach().cpu().numpy()
            for leaf in tree_leaves(ensemble.values)]
    if len(vals) == 1:
        return ProbVal.from_unzipped(list(w), list(vals[0]))
    return ProbVal.from_unzipped(
        list(w), [tuple(v[i] for v in vals) for i in range(len(w))])
