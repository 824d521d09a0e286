"""Device-side exact ensemble executor: mid-circuit measurement at scale.

Port of :mod:`qbot_tpu.inference.ensemble_exec`
(``qbot_tpu/inference/ensemble_exec.py``), its plain formulation.  The
register is a batch of weighted PURE planar states (particles), a
``(B, 2, 2^n)`` float32 tensor on one device, and a measurement fans every
particle out over its outcomes,

    ψ_b → { P_k ψ_b / √p_bk  with weight  w_b · p_bk }  for each outcome k

— the exact ProbVal cartesian product.  The particle mixture Σ w |ψ⟩⟨ψ|
equals the interpreter's collapsed density at every step, while memory
stays B·2^n instead of 4^n.  The particle count is capped like ProbVal's
pruning: after each fan-out the ``max_particles`` heaviest branches are
kept (ties to the lower branch index, as ``jax.lax.top_k`` keeps them) and
the weights renormalised, the dropped mass accumulating in ``lost_mass``.

What differs from the reference, and why:

* Every function runs eagerly on the ensemble's device; the reference's
  jit cache (``_cached_exec``) has no counterpart.  Plans run through
  :func:`qbot_tpu_torch.tpu.planar.apply_plan_planar` on the whole batch,
  each kernel in one launch for all particles.
* The (8, 128)-tiling carriers of the reference (``_safe_layouts`` and
  what it selects) exist for the TPU only and are not ported.  The states
  are viewed with a size-2 axis per target qubit and merged runs between
  them (:func:`qbot_tpu_torch.tpu.planar._grouped_view`), so no view
  exceeds PyTorch's dimension limits.
* The fan-outs rank all B·K (K²) branch weights first and build the states
  of the kept branches only, the sampled collapses the sampled outcome's
  state only: the same ensemble as building every branch and pruning, at
  the memory of the result.
* Randomness comes from a :class:`torch.Generator` on the ensemble's
  device (``measure_sample`` and friends take it where the reference takes
  a key); the outcomes differ from the reference's run for run, their
  distribution does not.
* Log-weights are float64 (a few numbers a particle; the reference's are
  float64 in its x64 CPU runs); states are float32.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from qbot_tpu_torch.inference.smc import (
    Ensemble as WEnsemble,
    effective_sample_size,
    systematic_resample,
)
from qbot_tpu_torch.tpu.compiler import Plan
from qbot_tpu_torch.tpu.planar import (
    _grouped_view,
    apply_plan_planar,
    planar_probs,
    product_state_planar,
)
from qbot_tpu_torch.utils import profiling

__all__ = ["QuantumEnsemble", "init_ensemble", "init_product_ensemble",
           "init_mixed_ensemble", "uniform_ensemble", "apply_plan_ensemble",
           "measure_fanout", "measure_sample", "discard_fanout",
           "discard_sample", "replace_fanout", "replace_sample", "peek_probs",
           "concat_resampled", "concat_weighted", "ensemble_mixture",
           "MAX_PARTICLES"]

MAX_PARTICLES = 256
_MIN_P = 1e-12
LOG_DTYPE = torch.float64


class QuantumEnsemble(NamedTuple):
    """Weighted batch of planar pure states; exact branch semantics.

    ``lost_mass`` is the cumulative probability mass dropped by branch
    pruning so far, the exact error bound on every subsequent outcome
    probability (|p_reported − p_exact| ≤ lost_mass in total variation);
    a float or a 0-d float64 tensor on the ensemble's device.
    """
    log_w: torch.Tensor              # (B,) float64
    psi: torch.Tensor                # (B, 2, 2^n) planar float32
    lost_mass: torch.Tensor | float = 0.0

    @property
    def num_particles(self) -> int:
        return self.log_w.shape[0]

    def weights(self) -> torch.Tensor:
        w = torch.exp(self.log_w)
        return w / torch.sum(w)

    @staticmethod
    def from_numpy(log_w, psi, lost_mass=0.0, device="cuda"
                   ) -> "QuantumEnsemble":
        """An ensemble on ``device`` from numpy arrays (log-weights (B,),
        planar states (B, 2, 2^n)), as the reference's ensemble carries
        them: tests start both packages from the same ensemble."""
        return QuantumEnsemble(
            torch.tensor(np.asarray(log_w), dtype=LOG_DTYPE, device=device),
            torch.tensor(np.asarray(psi), dtype=torch.float32,
                         device=device),
            float(np.asarray(lost_mass)))


def init_ensemble(psi0: torch.Tensor) -> QuantumEnsemble:
    """Single-particle ensemble from a planar (2, 2^n) state."""
    return QuantumEnsemble(
        torch.zeros(1, dtype=LOG_DTYPE, device=psi0.device),
        psi0[None].contiguous())


def init_product_ensemble(kets, B: int = 1,
                          device="cuda") -> QuantumEnsemble:
    """Uniform B-particle ensemble of the product state ⊗kets, built on
    ``device`` (:func:`~qbot_tpu_torch.tpu.planar.product_state_planar`:
    no 2^n array on the host).  The B copies are materialised: the kernels
    take contiguous states."""
    return uniform_ensemble(product_state_planar(kets, device), B)


def uniform_ensemble(psi1: torch.Tensor, B: int = 1) -> QuantumEnsemble:
    """Uniform B-particle ensemble of the planar (2, 2^n) state ``psi1``:
    B = 1 holds ``psi1`` itself, B > 1 materialised copies (the kernels
    take contiguous states)."""
    if B == 1:
        return init_ensemble(psi1)
    return QuantumEnsemble(
        torch.full((B,), -np.log(B), dtype=LOG_DTYPE, device=psi1.device),
        psi1.expand(B, *psi1.shape).contiguous())


def _lost(ens: QuantumEnsemble) -> torch.Tensor:
    if isinstance(ens.lost_mass, torch.Tensor):
        return ens.lost_mass.to(dtype=LOG_DTYPE, device=ens.log_w.device)
    return profiling.upload(np.asarray(ens.lost_mass, np.float64),
                            ens.log_w.device)


def _prune(log_w, max_particles: int, lost_mass):
    """The heaviest ``max_particles`` branches, renormalised.

    Returns (log_w, kept branch indices or None when all are kept,
    lost_mass') with the cumulative pruned-mass accumulator updated:
    lost' = lost + retained_so_far · dropped_fraction.  Among equal
    weights the lower index is kept first, as ``jax.lax.top_k`` keeps it
    (a stable descending sort), so a pruned run keeps the reference's
    branches.
    """
    total = log_w.shape[0]
    keep = min(max_particles, total)
    idx = None
    if keep < total:
        mass_before = torch.sum(torch.exp(log_w))
        log_w, idx = torch.sort(log_w, descending=True, stable=True)
        log_w, idx = log_w[:keep], idx[:keep]
        dropped = 1.0 - torch.sum(torch.exp(log_w)) / mass_before
        lost_mass = lost_mass + (1.0 - lost_mass) * dropped
    log_w = log_w - torch.logsumexp(log_w, dim=0)
    return log_w, idx, lost_mass


def init_mixed_ensemble(rho: np.ndarray, tol: float = 1e-12,
                        device="cuda") -> QuantumEnsemble:
    """Ensemble from a (possibly mixed) density matrix: its eigenensemble.

    ρ = Σ λᵢ|vᵢ⟩⟨vᵢ| becomes one particle per λᵢ > tol (the eigensolve
    runs on the host, float64): mixed-state preparation at B·2^n memory
    instead of 4^n.
    """
    rho = np.asarray(rho, complex)
    vals, vecs = np.linalg.eigh(rho)
    keep = vals > tol
    vals, vecs = vals[keep], vecs[:, keep]
    psi = np.stack([np.stack([vecs[:, i].real, vecs[:, i].imag])
                    for i in range(vals.shape[0])]).astype(np.float32)
    return QuantumEnsemble(
        torch.log(profiling.upload(
            np.asarray(vals / vals.sum(), np.float64), device)),
        profiling.upload(psi, device))


def apply_plan_ensemble(ens: QuantumEnsemble, plan: Plan,
                        params=None) -> QuantumEnsemble:
    """Run ``plan`` on every particle, with the angles ``params`` shared by
    all (``qbot_tpu/inference/ensemble_exec.py:158``): each of its kernels
    launches once for the whole batch."""
    return QuantumEnsemble(ens.log_w, apply_plan_planar(ens.psi, plan,
                                                        params),
                           ens.lost_mass)


# --- outcome blocks ---------------------------------------------------------
#
# A (B, 2, 2^n) batch viewed as (B, 2, *shape) with one size-2 axis per
# (sorted) target qubit: outcome k of the targets (big-endian over the
# sorted targets, as the reference's _outcome_split orders them) is the
# sub-block that fixes each target axis to its bit of k.

class _Blocks:
    """The grouped view of an ``n``-qubit batch with the ``targets`` (in
    sorted order) on axes of their own."""

    def __init__(self, n: int, targets):
        self.targets = sorted(targets)
        self.t = len(self.targets)
        self.K = 2 ** self.t
        self.shape, axes, _ = _grouped_view(n, self.targets)
        self.axes = [2 + a for a in axes]      # in the (B, 2, *shape) view

    def view(self, psi: torch.Tensor) -> torch.Tensor:
        return psi.reshape(psi.shape[0], 2, *self.shape)

    def index(self, k: int) -> tuple:
        """The view's index of outcome k's block (particles and planes
        kept): the remaining axes in qubit order."""
        idx = [slice(None)] * (2 + len(self.shape))
        for i, ax in enumerate(self.axes):
            idx[ax] = (k >> (self.t - 1 - i)) & 1
        return tuple(idx)

    def probs(self, psi: torch.Tensor) -> torch.Tensor:
        """(B, K) outcome probabilities of every particle."""
        return planar_probs(psi, self.targets, psi.shape[-1].bit_length() - 1)


def _weights_of(log_w, p_all):
    """The ensemble marginal (w / Σw) @ p_all, in float64."""
    w = torch.exp(log_w)
    return (w / torch.sum(w)) @ p_all.to(log_w.dtype)


def _inv_sqrt(p):
    return 1.0 / torch.sqrt(torch.clamp(p, min=_MIN_P))


def _logp(p_all):
    return torch.log(torch.clamp(p_all, min=_MIN_P))


def _rows(sel: torch.Tensor, values: torch.Tensor, v: int):
    """(positions in ``sel`` whose value is ``v``, those entries of sel)."""
    at = torch.nonzero(values == v).reshape(-1)
    return at, sel[at]


def peek_probs(ens: QuantumEnsemble, n: int, targets: Sequence[int]
               ) -> torch.Tensor:
    """Ensemble-marginal outcome distribution, no state change."""
    return _weights_of(ens.log_w, _Blocks(n, targets).probs(ens.psi))


def measure_fanout(ens: QuantumEnsemble, n: int, targets: Sequence[int],
                   max_particles: int = MAX_PARTICLES,
                   mode: str = "reference"
                   ) -> tuple[QuantumEnsemble, torch.Tensor]:
    """Measure + collapse: fan particles over outcomes, prune to the
    ``max_particles`` heaviest branches, renormalise.

    ``mode="projective"``: textbook update ρ → Σ_k P_k ρ P_k — each
    particle fans K ways into |k⟩_A ⊗ φ_k with weight w·p_k, preserving
    classical outcome↔rest correlations.

    ``mode="reference"`` (default): the reference interpreter's semantics
    (measurement.py:154-163): the measured subsystem is REPLACED by the
    outcome mixture and decoupled from the rest, ρ → Tr_A(ρ) ⊗ Σ p_k P_k.
    As pure states that is the K² fan-out |k⟩_A ⊗ φ_j with weight
    w·p_j·p_k (the j=k diagonal is the projective case).

    Returns (new ensemble, outcome distribution (K,) before pruning).
    """
    if mode not in ("projective", "reference"):
        raise ValueError(f"unknown collapse mode {mode!r}")
    blk = _Blocks(n, targets)
    B, K = ens.num_particles, blk.K
    p_all = blk.probs(ens.psi)                        # (B, K)
    dist = _weights_of(ens.log_w, p_all)
    logp = _logp(p_all)
    if mode == "projective":
        log_w = (ens.log_w[:, None] + logp).reshape(B * K)
    else:
        log_w = (ens.log_w[:, None, None] + logp[:, :, None]
                 + logp[:, None, :]).reshape(B * K * K)
    log_w, sel, lost = _prune(log_w, max_particles, _lost(ens))
    if sel is None:
        sel = torch.arange(log_w.shape[0], device=log_w.device)
    # branch (b, j, k): block j of particle b, renormalised, placed in
    # block k (projective: k = j)
    if mode == "projective":
        b_of, j_of, k_of = sel // K, sel % K, sel % K
    else:
        b_of, j_of, k_of = sel // (K * K), (sel // K) % K, sel % K
    src = blk.view(ens.psi)
    out = torch.zeros((sel.shape[0], 2, *blk.shape), dtype=ens.psi.dtype,
                      device=ens.psi.device)
    inv = _inv_sqrt(p_all)
    for j in range(K):
        for k in range(K):
            with profiling.sync():
                at = torch.nonzero((j_of == j) & (k_of == k)).reshape(-1)
            if at.numel() == 0:
                continue
            b = b_of[at]
            block = src.index_select(0, b)[blk.index(j)]
            scale = inv[b, j].reshape(-1, *[1] * (block.dim() - 1))
            out[(at,) + blk.index(k)[1:]] = block * scale
    psi = out.reshape(sel.shape[0], 2, -1)
    return QuantumEnsemble(log_w, psi, lost), dist


def _extract(ens_psi, blk: _Blocks, b_of, a_of, inv_sel, n_out):
    """States of the traced-out branches: block a_of[m] of particle
    b_of[m], scaled by inv_sel[m], as (M, 2, 2^(n - t))."""
    src = blk.view(ens_psi)
    M = b_of.shape[0]
    out = torch.empty((M, 2, 2 ** n_out), dtype=ens_psi.dtype,
                      device=ens_psi.device)
    for a in range(blk.K):
        with profiling.sync():
            at = torch.nonzero(a_of == a).reshape(-1)
        if at.numel() == 0:
            continue
        block = src.index_select(0, b_of[at])[blk.index(a)]
        block = block.reshape(at.shape[0], 2, -1)
        out[at] = block * inv_sel[at].reshape(-1, 1, 1).to(block.dtype)
    return out


def discard_fanout(ens: QuantumEnsemble, n: int, targets: Sequence[int],
                   max_particles: int = MAX_PARTICLES) -> QuantumEnsemble:
    """``disc`` at scale: partial-trace the targets out of the mixture.

    Each particle fans out over the discarded subsystem's basis states,
    the axes are dropped, and the heaviest ``max_particles`` branches are
    kept: Σ w|ψ⟩⟨ψ| equals Tr_A of the pre-discard mixture exactly (up to
    the prune).  The register shrinks by len(targets) qubits.
    """
    blk = _Blocks(n, targets)
    B, K = ens.num_particles, blk.K
    p_all = blk.probs(ens.psi)
    log_w = (ens.log_w[:, None] + _logp(p_all)).reshape(B * K)
    log_w, sel, lost = _prune(log_w, max_particles, _lost(ens))
    if sel is None:
        sel = torch.arange(log_w.shape[0], device=log_w.device)
    b_of, a_of = sel // K, sel % K
    psi = _extract(ens.psi, blk, b_of, a_of, _inv_sqrt(p_all[b_of, a_of]),
                   n - blk.t)
    return QuantumEnsemble(log_w, psi, lost)


def _sample_outcomes(gen: torch.Generator, p_all) -> torch.Tensor:
    """One outcome a particle from its own Born distribution (the
    reference's categorical over log(clip(p)))."""
    probs = torch.clamp(p_all, min=_MIN_P).to(LOG_DTYPE)
    return torch.multinomial(probs, 1, generator=gen).reshape(-1)


def _resample_below(gen, log_w0, values, ess_threshold: float):
    """(log_w, values) systematically resampled when the ESS of ``log_w0``
    is below ``ess_threshold``·B, else as they are."""
    B = log_w0.shape[0]
    if profiling.host_float(effective_sample_size(log_w0)) \
            < ess_threshold * B:
        r = systematic_resample(gen, WEnsemble(log_w0, values))
        return r.log_weights, r.values
    return log_w0, values


def discard_sample(gen: torch.Generator, ens: QuantumEnsemble, n: int,
                   targets: Sequence[int], ess_threshold: float = 0.5
                   ) -> QuantumEnsemble:
    """SMC-mode ``disc``: sample ONE traced-out basis state per particle
    (optimal Born proposal, constant particle count), dropping the axes."""
    blk = _Blocks(n, targets)
    p_all = blk.probs(ens.psi)
    outcomes = _sample_outcomes(gen, p_all)
    b_of = torch.arange(ens.num_particles, device=ens.psi.device)
    psi = _extract(ens.psi, blk, b_of, outcomes,
                   _inv_sqrt(p_all[b_of, outcomes]), n - blk.t)
    log_w, psi = _resample_below(gen, ens.log_w, psi, ess_threshold)
    return QuantumEnsemble(log_w, psi, ens.lost_mass)


def measure_sample(gen: torch.Generator, ens: QuantumEnsemble, n: int,
                   targets: Sequence[int], ess_threshold: float = 0.5
                   ) -> tuple[QuantumEnsemble, torch.Tensor, torch.Tensor]:
    """SMC-mode measurement: SAMPLE one outcome per particle instead of
    fanning out — the particle count stays constant, so arbitrarily deep
    measurement sequences run at fixed memory.

    Outcomes are drawn from each particle's own Born distribution, the
    optimal SMC proposal: incremental importance weights are constant, so
    weights stay untouched; systematic resampling triggers when
    ESS < threshold·B.  Only the sampled outcome's state is formed (the
    reference's outcome-mask path), so the collapse takes one ensemble's
    memory, not K.

    Returns (new ensemble, marginal outcome distribution (K,) before
    sampling, sampled outcomes (B,)).
    """
    blk = _Blocks(n, targets)
    B = ens.num_particles
    p_all = blk.probs(ens.psi)
    outcomes = _sample_outcomes(gen, p_all)
    b_of = torch.arange(B, device=ens.psi.device)
    inv = _inv_sqrt(p_all[b_of, outcomes])
    # psi * mask_k / √p_k: the mask keeps the target axes' bits of k
    mask = torch.ones((B, 1, *[1] * len(blk.shape)), dtype=ens.psi.dtype,
                      device=ens.psi.device)
    for i, ax in enumerate(blk.axes):
        bit = (outcomes >> (blk.t - 1 - i)) & 1
        onehot = torch.nn.functional.one_hot(bit, 2).to(ens.psi.dtype)
        shape = [B] + [1] * (1 + len(blk.shape))
        shape[ax] = 2
        mask = mask * onehot.reshape(shape)
    scale = inv.reshape(B, *[1] * (1 + len(blk.shape)))
    psi = (blk.view(ens.psi) * (mask * scale)).reshape(ens.psi.shape)
    dist = _weights_of(ens.log_w, p_all)
    log_w, (psi, outcomes) = _resample_below(gen, ens.log_w,
                                             (psi, outcomes), ess_threshold)
    return QuantumEnsemble(log_w, psi, ens.lost_mass), dist, outcomes


def _insert_block(phi, rest, n: int, targets: Sequence[int]):
    """Tensor 2^t planar kets ``phi`` ((2, 2^t), or one a row (M, 2, 2^t))
    into positions ``targets`` of the (n−t)-qubit planar rows ``rest``
    (M, 2, 2^(n−t)): phi's qubit j lands on ``targets[j]`` (reference
    ``replaceArbitrary`` order, unsorted target lists too)."""
    t = len(targets)
    M = rest.shape[0]
    if phi.dim() == 2:
        phi = phi.expand(M, *phi.shape)
    shape, axes, runs = _grouped_view(n, targets)
    run_shape = [shape[r] for r in runs]
    pr = phi[:, 0].reshape(M, *[2] * t, *[1] * len(runs))
    pi = phi[:, 1].reshape(M, *[2] * t, *[1] * len(runs))
    rr = rest[:, 0].reshape(M, *[1] * t, *run_shape)
    ri = rest[:, 1].reshape(M, *[1] * t, *run_shape)
    out = torch.stack([pr * rr - pi * ri, pr * ri + pi * rr], dim=1)
    # (M, 2, phi qubits in target order, runs) -> (M, 2, grouped view)
    src_of = {ax: 2 + j for j, ax in enumerate(axes)}
    src_of.update({r: 2 + t + i for i, r in enumerate(runs)})
    out = out.permute(0, 1, *[src_of[a] for a in range(len(shape))])
    return out.reshape(M, 2, 2 ** n)


def _new_states(new_states, device):
    """(log weights (NB,), planar kets (NB, 2, 2^t)) of a new state's
    eigen-branches ((weight, planar ket), ...)."""
    w = np.asarray([float(w) for w, _ in new_states])
    phis = np.stack([np.asarray(phi, np.float32) for _, phi in new_states])
    return w, profiling.upload(phis, device)


def replace_fanout(ens: QuantumEnsemble, n: int, targets: Sequence[int],
                   new_states, max_particles: int = MAX_PARTICLES
                   ) -> QuantumEnsemble:
    """Targeted ``qset`` at scale: replace the ``targets`` qubits with a
    new state (reference semantics: qbot/operators.py:
    133-166 via density.replaceArbitrary).

    On the pure-state particle ensemble this is a partial trace plus a
    tensor insertion: each particle fans out over the traced subsystem's
    basis states (exactly :func:`discard_fanout`) and each fan branch is
    tensored with each eigen-branch of the new state at the SAME qubit
    positions.  The register width is unchanged.

    ``new_states``: ((weight, planar_ket 2×2^t), …) — the eigen-ensemble
    of the new state (a pure new state is a single branch).
    """
    blk = _Blocks(n, targets)
    B, K = ens.num_particles, blk.K
    wb, phis = _new_states(new_states, ens.psi.device)
    p_all = blk.probs(ens.psi)
    base = (ens.log_w[:, None] + _logp(p_all)).reshape(B * K)
    log_w = torch.cat([base + float(np.log(w)) for w in wb])
    log_w, sel, lost = _prune(log_w, max_particles, _lost(ens))
    if sel is None:
        sel = torch.arange(log_w.shape[0], device=log_w.device)
    nb_of, ba = sel // (B * K), sel % (B * K)
    b_of, a_of = ba // K, ba % K
    rests = _extract(ens.psi, blk, b_of, a_of,
                     _inv_sqrt(p_all[b_of, a_of]), n - blk.t)
    psi = _insert_block(phis[nb_of].to(rests.dtype), rests, n,
                        list(targets))
    return QuantumEnsemble(log_w, psi, lost)


def replace_sample(gen: torch.Generator, ens: QuantumEnsemble, n: int,
                   targets: Sequence[int], new_states) -> QuantumEnsemble:
    """SMC-mode targeted ``qset``: constant particle count — per particle,
    sample ONE traced-out basis state of the target subsystem (the
    optimal Born proposal, as :func:`discard_sample`) and ONE eigen-branch
    of the new state (an exact categorical over its weights), then tensor
    the branch ket back in at the target positions.  Both draws sample
    their distributions exactly, so importance weights are untouched."""
    blk = _Blocks(n, targets)
    B = ens.num_particles
    wb, phis = _new_states(new_states, ens.psi.device)
    p_all = blk.probs(ens.psi)
    outcomes = _sample_outcomes(gen, p_all)
    b_of = torch.arange(B, device=ens.psi.device)
    rests = _extract(ens.psi, blk, b_of, outcomes,
                     _inv_sqrt(p_all[b_of, outcomes]), n - blk.t)
    branch_w = profiling.upload(np.asarray(wb, np.float64), ens.psi.device)
    draws = torch.multinomial(branch_w.expand(B, -1), 1,
                              generator=gen).reshape(-1)
    psi = _insert_block(phis[draws].to(rests.dtype), rests, n, list(targets))
    return QuantumEnsemble(ens.log_w, psi, ens.lost_mass)


def _concat(weighted):
    log_w = torch.cat([q.log_w + float(np.log(p)) for p, q in weighted])
    psi = torch.cat([q.psi for _, q in weighted])
    total = sum(p for p, _ in weighted)
    lost = sum(p * _lost(q) for p, q in weighted) / total
    return log_w, psi, lost


def concat_resampled(gen: torch.Generator, weighted,
                     B: int) -> QuantumEnsemble:
    """Weight-concatenate [(p, QuantumEnsemble)] and systematically
    resample back down to ``B`` particles — the SMC-mode mixture of
    per-branch ensembles at constant memory.  Systematic resampling is
    unbiased for every mixture expectation; total weight is conserved
    (uniform over the survivors), and ``lost_mass`` combines as the
    p-weighted bound.
    """
    lw, ps, lost = _concat(weighted)
    m = torch.max(lw)
    w = torch.exp(lw - m)
    z = torch.clamp(torch.sum(w), min=_MIN_P)
    u = torch.rand((), generator=gen, dtype=lw.dtype, device=gen.device)
    u = (u.to(lw.device) + torch.arange(B, dtype=lw.dtype,
                                        device=lw.device)) / B
    idx = torch.clamp(torch.searchsorted(torch.cumsum(w / z, dim=0), u),
                      0, lw.shape[0] - 1)
    share = profiling.host_float(m + torch.log(z) - np.log(B))
    new_lw = torch.full((B,), share, dtype=lw.dtype, device=lw.device)
    return QuantumEnsemble(new_lw, ps[idx], lost)


def concat_weighted(weighted, max_particles: int = MAX_PARTICLES
                    ) -> QuantumEnsemble:
    """Weight-concatenate [(p, QuantumEnsemble)] into one pruned ensemble.

    ``lost_mass`` combines as the p-weighted mixture bound Σ pᵢεᵢ / Σ pᵢ
    before the prune accumulates on top.
    """
    log_w, psi, lost = _concat(weighted)
    log_w, idx, lost = _prune(log_w, max_particles, lost)
    return QuantumEnsemble(log_w, psi if idx is None else psi[idx], lost)


def ensemble_mixture(ens: QuantumEnsemble) -> np.ndarray:
    """Σ w |ψ⟩⟨ψ| as a complex density matrix (host-side; conformance)."""
    w = ens.weights().cpu().numpy()
    psi = ens.psi.detach().cpu().numpy()
    kets = psi[:, 0] + 1j * psi[:, 1]
    return np.einsum("b,bi,bj->ij", w, kets, np.conj(kets))
