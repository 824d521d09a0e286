"""Mesh-sharded weighted particle ensembles: mid-circuit measurement on a
P × Q mesh of ``torch.distributed`` ranks.

Port of :mod:`qbot_tpu.tpu.sharded_ensemble`
(``qbot_tpu/tpu/sharded_ensemble.py``).  The particle batch ``(B, 2, 2^n)``
of :mod:`qbot_tpu_torch.inference.ensemble_exec` lives on an
:class:`~qbot_tpu_torch.tpu.sharding.EnsembleMesh`:

* the **particle axis** splits the batch over P rows of ranks, Bl = B / P
  particles a row (the batch is padded to a multiple of P with dead
  particles at log-weight −1e30);
* the **qubit axis** shards each particle's planar state over the leading
  k = log2 Q qubits of its row's Q ranks, as
  :mod:`qbot_tpu_torch.tpu.sharded` shards one register, so a rank holds a
  ``(Bl, 2, 2^(n-k))`` block.  A register too narrow to shard (n − k < k)
  is replicated over its row (``q_sharded=False``), each rank holding
  ``(Bl, 2, 2^n)``.

SPMD: every rank runs every function with the same arguments.  A plan runs
on the row's :class:`~qbot_tpu_torch.tpu.sharding.QubitMesh` through the
sharded register's executor, its local segments on the whole local batch
(one kernel launch a step for the Bl particles: the hand-written kernels on
a CUDA rank, their plain versions on a CPU rank).  Collapse events localise
their targets first (the caller's reshards), then split outcomes
shard-locally:

* Born probabilities — ``all_reduce`` over the row (the qubit axis); a
  target on a sharded axis reads its outcome bit off the rank, no data
  movement;
* weight normalisation and the mixture marginal — over the column (the
  particle axis);
* prune — a per-row top-k quota (``max_particles / P`` each).  It equals
  the global top-k when the surviving branches spread evenly over the
  rows; when they do not, more mass may be dropped, but ``lost_mass``
  accumulates the mass actually dropped (summed over the particle axis),
  so the reported total-variation bound stays exact;
* SMC resampling — island-local systematic resampling: each row resamples
  within itself and keeps its island weight, and
  :func:`maybe_exchange_islands` resamples whole islands when their
  weights degenerate.

Every host decision that depends on device values (outcome draws, ESS
tests, the island exchange) is made from a collective's result, identical
on every rank it concerns, so the ranks issue the same collectives in the
same order.  Randomness: each row draws from its own ``torch.Generator``,
the same on the row's Q ranks (:func:`row_generator`); the island exchange
draws from one generator the same on every rank.  ``stats`` counts each
collective where it is issued (``num_collectives``), as the reference's
``_count`` does.

What differs from the reference, and why:

* Each function runs eagerly on the rank; the reference's jit cache
  (``_JIT_CACHE``, ``_cached_jit``, ``_mesh_key``, ``_pre_digest``), the
  5-D carrier boundaries (``_boundary_reshape``, the ``_safe_layouts``
  branches), donation and the fused pre/post plans exist for XLA and the
  TPU and are not ported.
* Log-weights are float64, as in the port's single-device ensemble.
* :func:`concat_sharded` concatenates each row's blocks where they lie;
  the reference re-splits the concatenated global batch over the rows.
  The mixture is the same; a per-row prune that cuts after a concat may
  keep other branches than the reference's (``lost_mass`` stays exact).
* The new-state kets of a targeted ``qset`` keep their dtype until they
  are cast once to the state's (the reference casts them to float32
  first, ``sharded_ensemble.py:797, 1185``), and no process-wide
  warnings filter is set (``:100``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from qbot_tpu_torch.inference import ensemble_exec as ee
from qbot_tpu_torch.inference.smc import island_indices, systematic_indices
from qbot_tpu_torch.tpu.planar import product_state_planar
from qbot_tpu_torch.tpu.sharded import (
    ShardedPlan,
    _bit,
    make_sharded_planar_runner,
    unpermute_planar,
)
from qbot_tpu_torch.tpu.sharding import EnsembleMesh, QubitMesh

__all__ = ["ShardedEnsemble", "init_sharded_ensemble",
           "init_product_sharded_ensemble", "row_generator",
           "mesh_generator",
           "apply_sharded_plan_ensemble", "measure_fanout_sharded",
           "discard_fanout_sharded", "replace_fanout_sharded",
           "measure_sample_sharded", "discard_sample_sharded",
           "peek_probs_sharded", "replace_sample_sharded",
           "resample_down_sharded", "prune_sharded", "concat_sharded",
           "maybe_exchange_islands", "island_log_weights",
           "gather_ensemble", "sharded_ensemble_mixture"]

_NEG = -1e30          # dead-particle log-weight (exp underflows to 0)
_MIN_P = 1e-12
LOG_DTYPE = ee.LOG_DTYPE


class ShardedEnsemble(NamedTuple):
    """This rank's block of a weighted particle batch on the mesh.

    ``log_w``: (Bl,) float64, this row's particles (the same on the row's
    ranks); ``psi``: (Bl, 2, 2^(n-k)) float32, their shards on this rank
    (2^n when the register is replicated); ``lost_mass``: the cumulative
    pruned-probability bound, the same on every rank, as in
    :class:`~qbot_tpu_torch.inference.ensemble_exec.QuantumEnsemble`;
    ``shards``: P, the rows the batch is split over; ``q_sharded``: whether
    the states are sharded over the row or replicated on it.
    """
    log_w: torch.Tensor
    psi: torch.Tensor
    lost_mass: torch.Tensor | float = 0.0
    shards: int = 1
    q_sharded: bool = True

    @property
    def num_particles(self) -> int:
        """B, the particles of every row (dead pad particles included)."""
        return self.log_w.shape[0] * self.shards

    @property
    def local_particles(self) -> int:
        return self.log_w.shape[0]


def _count(stats, n: int = 1) -> None:
    if stats is not None:
        stats["num_collectives"] = stats.get("num_collectives", 0) + n


def _reduce(axis: QubitMesh, t: torch.Tensor, stats,
            op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks of one mesh axis (a new tensor): one
    counted ``all_reduce``, issued on an axis of one rank too."""
    out = t.clone()
    dist.all_reduce(out, op=op, group=axis.group)
    _count(stats)
    return out


def _lost(ens: ShardedEnsemble) -> torch.Tensor:
    return torch.as_tensor(ens.lost_mass, dtype=LOG_DTYPE,
                           device=ens.log_w.device)


def _local_n(n: int, emesh: EnsembleMesh, q_sharded: bool) -> tuple:
    """(k, n − k) of an n-qubit register, k = 0 when it is replicated."""
    k = emesh.k if q_sharded else 0
    return k, n - k


def row_generator(seed: int, emesh: EnsembleMesh) -> torch.Generator:
    """The generator of this rank's row, seeded from (``seed``, p): the
    same on the row's Q ranks, other on every row; row 0's is seeded
    with ``seed`` itself, so a P = 1 mesh draws what one device draws."""
    return torch.Generator(device=emesh.device).manual_seed(
        seed + (emesh.p << 32))


def mesh_generator(seed: int, emesh: EnsembleMesh) -> torch.Generator:
    """The generator of the island exchange, the same on every rank (the
    seed of a row P, which no rank has)."""
    return torch.Generator(device=emesh.device).manual_seed(
        seed + (emesh.P << 32))


def _uniform(gen: torch.Generator) -> torch.Tensor:
    """One float64 draw in [0, 1), as the single-device ensemble draws
    its resampling uniform."""
    return torch.rand((), generator=gen, dtype=LOG_DTYPE, device=gen.device)


# ---------------------------------------------------------------------------
# placement (``qbot_tpu/tpu/sharded_ensemble.py:161-271``)
# ---------------------------------------------------------------------------

def _pad_batch(log_w: np.ndarray, psi: np.ndarray, multiple: int):
    """The batch padded with dead particles (log-weight −1e30, zero
    states) to a multiple of ``multiple``."""
    B = log_w.shape[0]
    rem = (-B) % multiple
    if rem:
        log_w = np.concatenate([log_w, np.full((rem,), _NEG, log_w.dtype)])
        psi = np.concatenate(
            [psi, np.zeros((rem,) + psi.shape[1:], psi.dtype)])
    return log_w, psi


def _shard_of(psi: torch.Tensor, emesh: EnsembleMesh,
              q_sharded: bool) -> torch.Tensor:
    """This rank's qubit shard of full states (..., 2, 2^n)."""
    if not q_sharded:
        return psi
    L = psi.shape[-1] // emesh.K
    return psi[..., emesh.q * L:(emesh.q + 1) * L]


def init_sharded_ensemble(psi0, emesh: EnsembleMesh, log_w=None,
                          q_sharded: bool = True) -> ShardedEnsemble:
    """Place a host batch of planar states on the mesh: this rank's block.

    ``psi0``: (2, 2^n) single state or (B, 2, 2^n) batch; ``log_w``
    defaults to uniform over the given batch.  The batch is padded with
    dead particles to a multiple of P."""
    psi0 = np.asarray(psi0, np.float32)
    if psi0.ndim == 2:
        psi0 = psi0[None]
    B = psi0.shape[0]
    lw = (np.full((B,), -np.log(B), np.float64) if log_w is None
          else np.asarray(log_w, np.float64))
    lw, psi0 = _pad_batch(lw, psi0, emesh.P)
    Bl = lw.shape[0] // emesh.P
    rows = slice(emesh.p * Bl, (emesh.p + 1) * Bl)
    psi = _shard_of(torch.from_numpy(psi0[rows]), emesh, q_sharded)
    return ShardedEnsemble(
        torch.from_numpy(lw[rows].copy()).to(emesh.device),
        psi.contiguous().to(emesh.device), 0.0, emesh.P, q_sharded)


def init_product_sharded_ensemble(kets, emesh: EnsembleMesh, B: int = 1,
                                  q_sharded: bool = True) -> ShardedEnsemble:
    """Uniform B-particle ensemble of the product state ⊗kets, built on
    the rank's device (:func:`~qbot_tpu_torch.tpu.planar.
    product_state_planar`) and cut to this rank's block: no 2^n array on
    the host.  B is padded with dead particles to a multiple of P."""
    B_pad = B + (-B) % emesh.P
    Bl = B_pad // emesh.P
    psi1 = _shard_of(product_state_planar(kets, emesh.device), emesh,
                     q_sharded)
    live = torch.arange(emesh.p * Bl, (emesh.p + 1) * Bl,
                        device=emesh.device) < B
    log_w = torch.full((Bl,), -np.log(B), dtype=LOG_DTYPE,
                       device=emesh.device).masked_fill(~live, _NEG)
    psi = psi1.expand(Bl, *psi1.shape) * live.to(psi1.dtype)[:, None, None]
    return ShardedEnsemble(log_w, psi.contiguous(), 0.0, emesh.P, q_sharded)


# ---------------------------------------------------------------------------
# plans on the batch (``qbot_tpu/tpu/sharded_ensemble.py:274-446``)
# ---------------------------------------------------------------------------

def _plan_mesh(splan: ShardedPlan, emesh: EnsembleMesh) -> QubitMesh:
    """The qubit mesh a plan runs on: the row's, or, for a replicated
    register's plan (k = 0), this rank alone."""
    if splan.k:
        return emesh.qubits
    return QubitMesh(None, 1, 0, emesh.device)


def apply_sharded_plan_ensemble(ens: ShardedEnsemble, splan: ShardedPlan,
                                emesh: EnsembleMesh,
                                params=None) -> ShardedEnsemble:
    """Run a qubit-sharded plan over every particle of the rank's block:
    :func:`~qbot_tpu_torch.tpu.sharded.make_sharded_planar_runner` on the
    row (no collective on the particle axis; reshards and reflection sums
    ride the qubit axis).  ``params`` feeds the parameterised gates."""
    run = make_sharded_planar_runner(splan, _plan_mesh(splan, emesh))
    return ens._replace(psi=run(ens.psi, params))


# ---------------------------------------------------------------------------
# collapse events: exact fan-out (``qbot_tpu/tpu/sharded_ensemble.py:
# 453-857``)
# ---------------------------------------------------------------------------

def _global_normalize(log_w, emesh: EnsembleMesh, stats):
    """log_w − log Σ_global exp(log_w): a max and a sum over the particle
    axis (two collectives)."""
    m = _reduce(emesh.particles, torch.max(log_w), stats, dist.ReduceOp.MAX)
    z = _reduce(emesh.particles, torch.sum(torch.exp(log_w - m)), stats)
    return log_w - (m + torch.log(z))


def _shard_outcome_index(shard_positions: Sequence[int], k: int,
                         q: int) -> int:
    """This rank's outcome bits of targets on sharded axes (its row rank
    ``q``'s bits, MSB-first over ascending positions)."""
    os_ = 0
    for pos in shard_positions:
        os_ = (os_ << 1) | _bit(q, k, pos)
    return os_


def _outcome_probs_local(psi, n_local: int, targets: Sequence[int],
                         emesh: EnsembleMesh, shard_positions=(),
                         k: int = 0, q_sharded: bool = True, stats=None):
    """(global Born probabilities (Bl, K), those of this rank's outcomes
    (Bl, K_l)), float32.  Outcome bit order: sharded targets (ascending
    position) then local targets (ascending axis), MSB-first.  A rank
    holds amplitude only for the outcomes whose sharded bits equal its
    own: its local probabilities scatter at offset os·K_l, and one sum
    over the qubit axis assembles them."""
    p_l = ee._Blocks(n_local, targets).probs(psi)
    K_l = p_l.shape[1]
    if shard_positions:
        os_ = _shard_outcome_index(shard_positions, k, emesh.q)
        rows = slice(os_ * K_l, (os_ + 1) * K_l)
        full = torch.zeros((p_l.shape[0], K_l << len(shard_positions)),
                           dtype=p_l.dtype, device=p_l.device)
        full[:, rows] = p_l
        p = _reduce(emesh.qubits, full, stats)
        return p, p[:, rows]
    if q_sharded:
        p = _reduce(emesh.qubits, p_l, stats)
        return p, p
    return p_l, p_l             # the register is replicated over the row


def _quota(B_total: int, K_fan: int, max_particles: int, Pshards: int):
    """(new local batch, whether a prune happens), decided on the host."""
    grown = B_total * K_fan
    if grown <= max_particles:
        return grown // Pshards, False
    keep = max(Pshards, (max_particles // Pshards) * Pshards)
    return keep // Pshards, True


def _prune_local(log_w, quota: int, lost, emesh: EnsembleMesh, stats):
    """The row's ``quota`` heaviest branches (ties to the lower index, as
    ``jax.lax.top_k`` keeps them), renormalised over the mesh.  Returns
    (log_w, kept indices or None when all are kept, lost') with lost'
    accumulating the mass actually dropped over every row."""
    total = log_w.shape[0]
    idx = None
    if quota < total:
        before = _reduce(emesh.particles, torch.sum(torch.exp(log_w)), stats)
        log_w, idx = torch.sort(log_w, descending=True, stable=True)
        log_w, idx = log_w[:quota], idx[:quota]
        after = _reduce(emesh.particles, torch.sum(torch.exp(log_w)), stats)
        dropped = 1.0 - after / torch.clamp(before, min=_MIN_P)
        lost = lost + (1.0 - lost) * dropped
    return _global_normalize(log_w, emesh, stats), idx, lost


def _collapsed(psi, blk, b_of, j_of, k_of, inv, K_l: int, os_):
    """States of the fan-out branches m: block j_of[m] % K_l of particle
    b_of[m], scaled by inv[b, j], placed in block k_of[m] % K_l; zero
    where the outcome's sharded bits (j // K_l) are not this rank's
    ``os_``.  (M, 2, 2^n_local)."""
    src = blk.view(psi)
    M = b_of.shape[0]
    out = torch.zeros((M, 2, *blk.shape), dtype=psi.dtype,
                      device=psi.device)
    pairs = torch.unique(torch.stack([j_of, k_of], dim=1), dim=0).tolist()
    for j, kk in pairs:
        if j // K_l != os_:
            continue
        at = torch.nonzero((j_of == j) & (k_of == kk)).reshape(-1)
        b = b_of[at]
        block = src.index_select(0, b)[blk.index(j % K_l)]
        scale = inv[b, j].reshape(-1, *[1] * (block.dim() - 1))
        out[(at,) + blk.index(kk % K_l)[1:]] = block * scale
    return out.reshape(M, 2, -1)


def measure_fanout_sharded(ens: ShardedEnsemble, n: int,
                           local_targets: Sequence[int],
                           emesh: EnsembleMesh,
                           max_particles: int = 256,
                           mode: str = "reference",
                           shard_positions: Sequence[int] = (),
                           q_sharded: bool = True,
                           stats: Optional[dict] = None):
    """Mesh twin of :func:`~qbot_tpu_torch.inference.ensemble_exec.
    measure_fanout`.

    ``local_targets`` are local axes of the (n−k)-qubit block;
    ``shard_positions`` target positions < k whose outcome bit is the
    rank's (no data movement).  ``mode="reference"`` relocates outcome
    blocks, which needs local targets: shard targets go with
    ``"projective"`` only.  Each particle fans out K ways (projective) or
    K² ways (reference) within its row; returns (pruned ensemble, outcome
    distribution (K,) float64 before the prune, on every rank)."""
    if mode not in ("projective", "reference"):
        raise ValueError(f"unknown collapse mode {mode!r}")
    if mode == "reference" and shard_positions:
        raise ValueError("reference-mode collapse needs localized targets")
    k, n_local = _local_n(n, emesh, q_sharded)
    blk = ee._Blocks(n_local, local_targets)
    K_l = blk.K
    K = K_l << len(shard_positions)
    Bl = ens.local_particles
    fan = K * K if mode == "reference" else K
    quota, _ = _quota(ens.num_particles, fan, max_particles, emesh.P)
    p_all, _ = _outcome_probs_local(ens.psi, n_local, local_targets, emesh,
                                    shard_positions, k, q_sharded, stats)
    w = torch.exp(_global_normalize(ens.log_w, emesh, stats))
    dist_ = _reduce(emesh.particles, w @ p_all.to(LOG_DTYPE), stats)
    logp = ee._logp(p_all)
    if mode == "projective":
        log_w = (ens.log_w[:, None] + logp).reshape(Bl * K)
    else:
        log_w = (ens.log_w[:, None, None] + logp[:, :, None]
                 + logp[:, None, :]).reshape(Bl * K * K)
    log_w, sel, lost = _prune_local(log_w, quota, _lost(ens), emesh, stats)
    if sel is None:
        sel = torch.arange(log_w.shape[0], device=log_w.device)
    if mode == "projective":
        b_of, j_of, k_of = sel // K, sel % K, sel % K
    else:
        b_of, j_of, k_of = sel // (K * K), (sel // K) % K, sel % K
    os_ = (_shard_outcome_index(shard_positions, k, emesh.q)
           if shard_positions else 0)
    psi = _collapsed(ens.psi, blk, b_of, j_of, k_of, ee._inv_sqrt(p_all),
                     K_l, os_)
    return ens._replace(log_w=log_w, psi=psi, lost_mass=lost), dist_


def _fan_split(ens: ShardedEnsemble, n: int, local_targets, emesh,
               q_sharded: bool, stats):
    """(blocks of the local targets, n_local, their global Born
    probabilities (Bl, K)) of a discard or a replace."""
    k, n_local = _local_n(n, emesh, q_sharded)
    p_all, _ = _outcome_probs_local(ens.psi, n_local, local_targets, emesh,
                                    (), k, q_sharded, stats)
    return ee._Blocks(n_local, local_targets), n_local, p_all


def discard_fanout_sharded(ens: ShardedEnsemble, n: int,
                           local_targets: Sequence[int],
                           emesh: EnsembleMesh,
                           max_particles: int = 256,
                           q_sharded: bool = True,
                           stats: Optional[dict] = None) -> ShardedEnsemble:
    """Mesh twin of :func:`~qbot_tpu_torch.inference.ensemble_exec.
    discard_fanout`: the register shrinks by len(local_targets) qubits
    (all local axes: localise first); the sharded axes stay."""
    blk, n_local, p_all = _fan_split(ens, n, local_targets, emesh,
                                     q_sharded, stats)
    Bl, K = ens.local_particles, blk.K
    quota, _ = _quota(ens.num_particles, K, max_particles, emesh.P)
    log_w = (ens.log_w[:, None] + ee._logp(p_all)).reshape(Bl * K)
    log_w, sel, lost = _prune_local(log_w, quota, _lost(ens), emesh, stats)
    if sel is None:
        sel = torch.arange(log_w.shape[0], device=log_w.device)
    b_of, a_of = sel // K, sel % K
    psi = ee._extract(ens.psi, blk, b_of, a_of,
                      ee._inv_sqrt(p_all[b_of, a_of]), n_local - blk.t)
    return ens._replace(log_w=log_w, psi=psi, lost_mass=lost)


def replace_fanout_sharded(ens: ShardedEnsemble, n: int,
                           local_targets: Sequence[int], new_states,
                           emesh: EnsembleMesh,
                           max_particles: int = 256,
                           q_sharded: bool = True,
                           stats: Optional[dict] = None) -> ShardedEnsemble:
    """Mesh twin of :func:`~qbot_tpu_torch.inference.ensemble_exec.
    replace_fanout` (targeted qset): ``local_targets`` are local axes
    (localise first), in the program's order; the partial trace's fan-out
    and the tensor insertion are shard-local, the only collectives the
    Born probabilities' sum and the prune's.  ``new_states``: ((weight,
    planar 2×2^t ket), …) eigen-branches of the new state."""
    blk, n_local, p_all = _fan_split(ens, n, local_targets, emesh,
                                     q_sharded, stats)
    Bl, K = ens.local_particles, blk.K
    wb, phis = ee._new_states(new_states, ens.psi.device)
    quota, _ = _quota(ens.num_particles, K * len(wb), max_particles,
                      emesh.P)
    base = (ens.log_w[:, None] + ee._logp(p_all)).reshape(Bl * K)
    log_w = torch.cat([base + float(np.log(w)) for w in wb])
    log_w, sel, lost = _prune_local(log_w, quota, _lost(ens), emesh, stats)
    if sel is None:
        sel = torch.arange(log_w.shape[0], device=log_w.device)
    nb_of, ba = sel // (Bl * K), sel % (Bl * K)
    b_of, a_of = ba // K, ba % K
    rests = ee._extract(ens.psi, blk, b_of, a_of,
                        ee._inv_sqrt(p_all[b_of, a_of]), n_local - blk.t)
    psi = ee._insert_block(phis[nb_of].to(rests.dtype), rests, n_local,
                           list(local_targets))
    return ens._replace(log_w=log_w, psi=psi, lost_mass=lost)


def peek_probs_sharded(ens: ShardedEnsemble, n: int,
                       local_targets: Sequence[int], emesh: EnsembleMesh,
                       shard_positions: Sequence[int] = (),
                       q_sharded: bool = True,
                       stats: Optional[dict] = None) -> torch.Tensor:
    """Mixture-marginal outcome distribution (K,) float64, no state
    change."""
    k, n_local = _local_n(n, emesh, q_sharded)
    p_all, _ = _outcome_probs_local(ens.psi, n_local, local_targets, emesh,
                                    shard_positions, k, q_sharded, stats)
    w = torch.exp(_global_normalize(ens.log_w, emesh, stats))
    return _reduce(emesh.particles, w @ p_all.to(LOG_DTYPE), stats)


# ---------------------------------------------------------------------------
# SMC (sampled) collapse: constant particle count, island resampling
# (``qbot_tpu/tpu/sharded_ensemble.py:863-1372``)
# ---------------------------------------------------------------------------

def _island_resample(gen, log_w, psi, ess_frac: float, threshold: float):
    """The row's systematic resampling within itself when the global ESS
    fraction is below ``threshold``: each survivor gets an equal share of
    the island's total weight.  One uniform from the row's generator,
    drawn only when it resamples."""
    if not ess_frac < threshold:
        return log_w, psi
    Bl = log_w.shape[0]
    idx, island = island_indices(log_w, _uniform(gen).to(log_w.device))
    return torch.full((Bl,), float(island - np.log(Bl)), dtype=log_w.dtype,
                      device=log_w.device), psi[idx]


def _ess_frac(lw_n, B_total: int, emesh: EnsembleMesh, stats) -> float:
    """The global effective sample size over B_total of normalised
    log-weights: two sums over the particle axis."""
    s1 = _reduce(emesh.particles, torch.sum(torch.exp(lw_n)), stats)
    s2 = _reduce(emesh.particles, torch.sum(torch.exp(2.0 * lw_n)), stats)
    return float(s1 * s1 / torch.clamp(s2, min=_MIN_P)) / B_total


def measure_sample_sharded(gen: torch.Generator, ens: ShardedEnsemble,
                           n: int, local_targets: Sequence[int],
                           emesh: EnsembleMesh, ess_threshold: float = 0.5,
                           shard_positions: Sequence[int] = (),
                           q_sharded: bool = True,
                           stats: Optional[dict] = None):
    """SMC-mode measurement on the mesh: each particle samples one outcome
    from its own Born distribution (summed over the qubit axis), the
    optimal proposal, so weights are untouched; island resampling when
    the global ESS falls below ``ess_threshold``·B.  ``gen`` is the row's
    generator (:func:`row_generator`): every qubit shard of a particle
    draws the same outcome.  Only the sampled outcome's state is formed.
    Returns (ensemble, outcome distribution (K,) before sampling)."""
    k, n_local = _local_n(n, emesh, q_sharded)
    blk = ee._Blocks(n_local, local_targets)
    Bl, K_l = ens.local_particles, blk.K
    p_all, _ = _outcome_probs_local(ens.psi, n_local, local_targets, emesh,
                                    shard_positions, k, q_sharded, stats)
    lw_n = _global_normalize(ens.log_w, emesh, stats)
    dist_ = _reduce(emesh.particles, torch.exp(lw_n) @ p_all.to(LOG_DTYPE),
                    stats)
    outcomes = ee._sample_outcomes(gen, p_all).to(ens.psi.device)
    b = torch.arange(Bl, device=ens.psi.device)
    scale = ee._inv_sqrt(p_all[b, outcomes])
    if shard_positions:
        os_ = _shard_outcome_index(shard_positions, k, emesh.q)
        scale = scale * (outcomes // K_l == os_).to(scale.dtype)
    local = outcomes % K_l
    # psi * mask / √p: the mask keeps the target axes' bits of the outcome
    mask = torch.ones((Bl, 1, *[1] * len(blk.shape)), dtype=ens.psi.dtype,
                      device=ens.psi.device)
    for i, ax in enumerate(blk.axes):
        bit = (local >> (blk.t - 1 - i)) & 1
        onehot = torch.nn.functional.one_hot(bit, 2).to(ens.psi.dtype)
        shape = [Bl] + [1] * (1 + len(blk.shape))
        shape[ax] = 2
        mask = mask * onehot.reshape(shape)
    scale = scale.reshape(Bl, *[1] * (1 + len(blk.shape)))
    psi = (blk.view(ens.psi) * (mask * scale)).reshape(ens.psi.shape)
    frac = _ess_frac(lw_n, ens.num_particles, emesh, stats)
    log_w, psi = _island_resample(gen, ens.log_w, psi, frac, ess_threshold)
    return ens._replace(log_w=log_w, psi=psi), dist_


def _sampled_rests(gen, ens: ShardedEnsemble, n: int, local_targets,
                   emesh: EnsembleMesh, q_sharded: bool, stats):
    """The sampled traced-out branch of every particle: (rests (Bl, 2,
    2^(n_local − t)), n_local)."""
    blk, n_local, p_all = _fan_split(ens, n, local_targets, emesh,
                                     q_sharded, stats)
    outcomes = ee._sample_outcomes(gen, p_all).to(ens.psi.device)
    b = torch.arange(ens.local_particles, device=ens.psi.device)
    rests = ee._extract(ens.psi, blk, b, outcomes,
                        ee._inv_sqrt(p_all[b, outcomes]), n_local - blk.t)
    return rests, n_local


def discard_sample_sharded(gen: torch.Generator, ens: ShardedEnsemble,
                           n: int, local_targets: Sequence[int],
                           emesh: EnsembleMesh, ess_threshold: float = 0.5,
                           q_sharded: bool = True,
                           stats: Optional[dict] = None) -> ShardedEnsemble:
    """SMC-mode ``disc`` on the mesh: one traced-out basis state sampled
    per particle; the register shrinks at constant particle count."""
    psi, _ = _sampled_rests(gen, ens, n, local_targets, emesh, q_sharded,
                            stats)
    lw_n = _global_normalize(ens.log_w, emesh, stats)
    frac = _ess_frac(lw_n, ens.num_particles, emesh, stats)
    log_w, psi = _island_resample(gen, ens.log_w, psi, frac, ess_threshold)
    return ens._replace(log_w=log_w, psi=psi)


def replace_sample_sharded(gen: torch.Generator, ens: ShardedEnsemble,
                           n: int, local_targets: Sequence[int], new_states,
                           emesh: EnsembleMesh, q_sharded: bool = True,
                           stats: Optional[dict] = None) -> ShardedEnsemble:
    """SMC-mode targeted ``qset`` on the mesh: per particle, one
    traced-out basis state of the (localised) targets sampled from its
    Born distribution and one eigen-branch of the new state from its
    weights, the branch ket tensored back in shard-locally.  Both draws
    are exact samples, so weights are untouched."""
    rests, n_local = _sampled_rests(gen, ens, n, local_targets, emesh,
                                    q_sharded, stats)
    wb, phis = ee._new_states(new_states, ens.psi.device)
    branch_w = torch.tensor(wb, dtype=LOG_DTYPE, device=gen.device)
    draws = torch.multinomial(branch_w.expand(ens.local_particles, -1), 1,
                              generator=gen).reshape(-1).to(phis.device)
    psi = ee._insert_block(phis[draws].to(rests.dtype), rests, n_local,
                           list(local_targets))
    return ens._replace(psi=psi)


def resample_down_sharded(gen: torch.Generator, ens: ShardedEnsemble,
                          B_target: int, emesh: EnsembleMesh,
                          q_sharded: bool = True,
                          stats: Optional[dict] = None) -> ShardedEnsemble:
    """Row-local systematic resample down to ``B_target`` particles
    (``B_target / P`` a row), each row keeping its island's total weight,
    shared equally: the SMC-mode replacement of the exact path's prune
    after a branch concat.  No collective."""
    Bl_out = max(1, B_target // emesh.P)
    idx, island = island_indices(ens.log_w, _uniform(gen).to(
        ens.log_w.device), Bl_out)
    log_w = torch.full((Bl_out,), float(island - np.log(Bl_out)),
                       dtype=ens.log_w.dtype, device=ens.log_w.device)
    return ens._replace(log_w=log_w, psi=ens.psi[idx])


def island_log_weights(ens: ShardedEnsemble, emesh: EnsembleMesh,
                       stats: Optional[dict] = None) -> torch.Tensor:
    """(P,) log total weight of every island (row), on every rank: one
    sum over the particle axis of each row's entry."""
    one = torch.zeros(emesh.P, dtype=LOG_DTYPE, device=ens.log_w.device)
    one[emesh.p] = torch.logsumexp(ens.log_w, dim=0)
    return _reduce(emesh.particles, one, stats)


def _exchange_rows(ens: ShardedEnsemble, src: list, emesh: EnsembleMesh,
                   stats) -> tuple:
    """(log_w, psi) of row ``src[p]`` on this rank of row p, the same
    qubit shard: one counted ``all_to_all_single`` over the particle axis,
    each rank sending its block (states and float64 log-weights, bit for
    bit) to every row that drew it."""
    p, P = emesh.p, emesh.P
    payload = torch.cat([ens.psi.reshape(-1),
                         ens.log_w.contiguous().view(torch.float32)])
    S = payload.numel()
    takers = sum(1 for d in range(P) if src[d] == p)
    send = payload.repeat(takers)
    recv = torch.empty_like(payload)
    dist.all_to_all_single(recv, send,
                           [S if r == src[p] else 0 for r in range(P)],
                           [S if src[d] == p else 0 for d in range(P)],
                           group=emesh.particles.group)
    _count(stats)
    n_psi = ens.psi.numel()
    return (recv[n_psi:].view(LOG_DTYPE),
            recv[:n_psi].reshape(ens.psi.shape))


def maybe_exchange_islands(gen: torch.Generator, ens: ShardedEnsemble,
                           emesh: EnsembleMesh, threshold: float = 0.5,
                           q_sharded: bool = True,
                           stats: Optional[dict] = None):
    """Global island-level resampling, triggered on the effective island
    count.

    Island resampling never moves particles between rows, so over deep
    measurement sequences the island weights themselves degenerate.  When
    the effective island count 1 / Σ wn_i² falls below ``threshold``·P,
    the islands are resampled systematically from their weights (``gen``:
    :func:`mesh_generator`, the same on every rank): each row takes a copy
    of a drawn source row's block and the total weight splits equally
    over the islands; relative weights within an island are kept.
    Returns (ensemble, exchanged?)."""
    P = emesh.P
    if P == 1:
        return ens, False
    L = island_log_weights(ens, emesh, stats)
    m = torch.max(L)
    wn = torch.exp(L - m)
    wn = wn / torch.clamp(torch.sum(wn), min=_MIN_P)
    n_eff = 1.0 / torch.clamp(torch.sum(wn * wn), min=_MIN_P)
    if not float(n_eff) < threshold * P:
        return ens, False
    src = systematic_indices(wn, _uniform(gen).to(wn.device)).tolist()
    total = m + torch.log(torch.clamp(torch.sum(torch.exp(L - m)),
                                      min=_MIN_P))
    lw_src, psi = _exchange_rows(ens, src, emesh, stats)
    log_w = lw_src - L[src[emesh.p]] + (total - np.log(P))
    if stats is not None:
        stats["island_exchanges"] = stats.get("island_exchanges", 0) + 1
    return ens._replace(log_w=log_w, psi=psi), True


def prune_sharded(ens: ShardedEnsemble, max_particles: int,
                  emesh: EnsembleMesh, q_sharded: bool = True,
                  stats: Optional[dict] = None) -> ShardedEnsemble:
    """Standalone quota prune (``max_particles / P`` a row) and global
    renormalisation."""
    if ens.num_particles <= max_particles:
        return ens
    quota = max(1, max_particles // emesh.P)
    log_w, idx, lost = _prune_local(ens.log_w, quota, _lost(ens), emesh,
                                    stats)
    return ens._replace(log_w=log_w, lost_mass=lost,
                        psi=ens.psi if idx is None else ens.psi[idx])


def concat_sharded(weighted, emesh: EnsembleMesh,
                   q_sharded: bool = True) -> ShardedEnsemble:
    """Weight-concatenate [(p, ShardedEnsemble)] along the particle axis,
    each row's blocks where they lie (no data movement).  All operands
    share one qubit layout (the mesh engine keeps the identity layout for
    this); ``lost_mass`` combines as the p-weighted mixture bound."""
    log_w, psi, lost = ee._concat(weighted)
    return weighted[0][1]._replace(log_w=log_w, psi=psi, lost_mass=lost)


# ---------------------------------------------------------------------------
# host readout (conformance, small n): collectives, every rank calls them
# ---------------------------------------------------------------------------

def _all_gather(t: torch.Tensor) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return parts


def gather_ensemble(ens: ShardedEnsemble, emesh: EnsembleMesh, perm=None):
    """(weights, complex kets) of the whole ensemble as numpy, on every
    rank: dead particles dropped, each state in logical qubit order
    (``perm``: physical → logical, identity if None).  Gathers every
    block (two ``all_gather`` over the mesh)."""
    lws = _all_gather(ens.log_w)
    psis = _all_gather(ens.psi)
    K = emesh.K
    log_w = torch.cat([lws[p * K] for p in range(emesh.P)]).cpu().numpy()
    rows = [torch.cat(psis[p * K:(p + 1) * K], dim=-1) if ens.q_sharded
            else psis[p * K] for p in range(emesh.P)]
    psi = torch.cat(rows).cpu()
    live = log_w > _NEG / 2
    log_w, psi = log_w[live], psi[torch.from_numpy(live)]
    w = np.exp(log_w - log_w.max())
    w = w / w.sum()
    if perm is not None and list(perm) != list(range(len(perm))):
        psi = unpermute_planar(psi, perm)
    psi = psi.numpy().astype(np.float64)
    return w, psi[:, 0] + 1j * psi[:, 1]


def sharded_ensemble_mixture(ens: ShardedEnsemble, emesh: EnsembleMesh,
                             perm=None) -> np.ndarray:
    """Σ w |ψ⟩⟨ψ| as a dense complex density matrix, on every rank (host;
    small n)."""
    w, kets = gather_ensemble(ens, emesh, perm)
    return np.einsum("b,bi,bj->ij", w, kets, np.conj(kets))
