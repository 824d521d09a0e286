"""Plain ensemble reference: every branch of a program with mid-circuit
measurement, enumerated depth first in complex128, and the comparison that
judges the program's final ensemble and readouts against it.

The semantics are those the program documents for its device ensemble
(``run_lowered_ensemble``):

- the exact fan-out (``sample`` 0) measures in the reference collapse
  mode: the measured qubits are replaced by the outcome mixture and
  decoupled from the rest, so a state fans into |k⟩ ⊗ φ_j with weight
  p_j · p_k for every pair of outcomes (j, k);
- a sampled run (``sample`` > 0) draws one outcome a particle from its own
  Born distribution and keeps the projected state: its possible final
  states are the branches of the projective fan-out, one outcome j a
  measurement, weight p_j;
- a discard fans a state over the discarded qubits' basis states, weight
  p_a, and drops their axes.

A branch of probability 1e-12 or less is not followed (the program clamps
probabilities there).  The readout of a measurement is the distribution of
its outcome over all branches that reach it.  It imports nothing of the
program: only the request's events.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.statevector import _no_tf32, apply_ops, worst, \
    zero_state

MIN_P = 1e-12              # branches of this probability or less end
WEIGHTED = 1e-9            # the program's particles that carry weight
SAME_STATE = 1e-12         # squared distance of two leaves held the same
APART = 1e-2               # projections closer than this are one branch
MIN_EXPECTED = 5.0         # a draw statistic's bin holds this many at least


def _at(n: int, targets, outcome: int) -> tuple:
    """Index of the block of ``outcome`` (big-endian over the sorted
    targets) in a (2,)*n state."""
    idx = [slice(None)] * n
    t = len(targets)
    for i, q in enumerate(targets):
        idx[q] = (outcome >> (t - 1 - i)) & 1
    return tuple(idx)


def _marginal(psi: torch.Tensor, targets) -> torch.Tensor:
    p = psi.real ** 2 + psi.imag ** 2
    rest = [a for a in range(psi.dim()) if a not in targets]
    if rest:
        p = torch.sum(p, dim=rest)
    return p.reshape(-1)


def enumerate_branches(request, device, dtype=torch.complex128):
    """(leaves, readouts): each leaf is (weight, final state flattened,
    {measurement: its outcome distribution on the leaf's path}); readouts
    are {measurement: distribution over all branches}.  In complex64 the
    gates' products are TF32's (the control)."""
    _no_tf32()
    events = request.events
    projective = request.sample > 0
    readouts: dict = {}
    leaves: list = []

    def visit(psi, w, e, conds):
        while e < len(events) and events[e][0] == "gates":
            psi = apply_ops(psi, events[e][1])
            e += 1
        if e == len(events):
            leaves.append((w, psi.reshape(-1), conds))
            return
        ev = events[e]
        n = psi.dim()
        if ev[0] == "disc":
            targets = sorted(ev[1])
            p = _marginal(psi, targets).cpu().numpy()
            for a in range(p.shape[0]):
                if p[a] > MIN_P:
                    child = psi[_at(n, targets, a)] / math.sqrt(p[a])
                    visit(child.contiguous(), w * p[a], e + 1, conds)
            return
        _, name, targets = ev
        targets = sorted(targets)
        p = _marginal(psi, targets).cpu().numpy()
        readouts[name] = readouts.get(name, 0.0) + w * p
        conds = {**conds, name: p}
        for j in range(p.shape[0]):
            if p[j] <= MIN_P:
                continue
            block = psi[_at(n, targets, j)] / math.sqrt(p[j])
            for k in ([j] if projective else range(p.shape[0])):
                if p[k] <= MIN_P:
                    continue
                child = torch.zeros_like(psi)
                child[_at(n, targets, k)] = block
                pk = 1.0 if projective else p[k]
                visit(child, w * p[j] * pk, e + 1, conds)

    visit(zero_state(request.n, device, dtype), 1.0, 0, {})
    return leaves, readouts


def _planar(states) -> torch.Tensor:
    psi = torch.stack(list(states))
    return torch.stack([psi.real, psi.imag], dim=1).float()


def control_outputs(request, device, seed: int) -> dict:
    """The control in the program's place: the outputs :func:`judge`
    reads, from :func:`enumerate_branches` in TF32.  The exact fan-out is
    every leaf at its weight; a sampled run draws ``sample`` leaves by
    weight (from ``seed``) at uniform weights, its readouts the first
    measurement's distribution and, after it, the mean of the drawn
    leaves' distributions."""
    leaves, readouts = enumerate_branches(request, device, torch.complex64)
    w = np.array([leaf[0] for leaf in leaves])
    if not request.sample:
        out = {"psi": _planar(leaf[1] for leaf in leaves),
               "log_w": torch.log(torch.from_numpy(w)), "lost_mass": 0.0,
               "readouts": readouts}
    else:
        rng = np.random.default_rng(seed)
        picks = rng.choice(len(leaves), size=request.sample, p=w / w.sum())
        first = next(e[1] for e in request.events if e[0] == "meas")
        drawn = {name: (readouts[name] if name == first else np.mean(
                 [leaves[j][2][name] for j in picks], axis=0))
                 for name in readouts}
        out = {"psi": _planar(leaves[j][1] for j in picks),
               "log_w": torch.full((request.sample,),
                                   -math.log(request.sample),
                                   dtype=torch.float64),
               "lost_mass": 0.0, "readouts": drawn}
    out["run_readouts"] = [out["readouts"]]
    if request.sample:
        probe = torch.randn((out["psi"].shape[-1], 2),
                            generator=torch.Generator().manual_seed(seed),
                            dtype=torch.float64)
        out["probe"] = probe
        out["projections"] = [(_project(out["psi"].double(), probe).numpy(),
                               out["log_w"].numpy())]
    return out


def _planar_rows(psi: torch.Tensor, rows, device) -> torch.Tensor:
    """Particles ``rows`` of a (P, 2, 2^m) float32 batch as (R, 2^m)
    complex128 on ``device``."""
    sel = psi[rows.to(psi.device)].to(device)
    return torch.complex(sel[:, 0].double(), sel[:, 1].double())


def _clusters(ref: torch.Tensor) -> list:
    """For each leaf, the first leaf of the same state."""
    norms = torch.sum(torch.abs(ref) ** 2, dim=1)
    d2 = (norms[:, None] + norms[None, :]
          - 2 * (ref.conj() @ ref.T).real).cpu().numpy()
    return [int(np.argmax(d2[i] <= SAME_STATE)) for i in range(len(ref))]


def _project(psi: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """(P, 2, k) projections of (P, 2, 2^m) planar states on the (2^m, k)
    probe vectors."""
    return (psi.reshape(-1, psi.shape[-1]) @ probe).reshape(
        psi.shape[0], 2, probe.shape[1])


class Branches:
    """The leaves grouped into branches a particle can be told to be in:
    leaves of one final state, or whose projections on the probe vectors
    lie within ``APART``, are one branch."""

    def __init__(self, leaves, ref: torch.Tensor, probe: torch.Tensor):
        same = _clusters(ref)
        planes = torch.stack([ref.real, ref.imag], dim=1)
        proj = _project(planes, probe.to(ref.device).double())
        self.flat = proj.cpu().numpy().reshape(len(leaves), -1)
        self.of = list(same)
        for i in range(len(leaves)):
            for j in range(i):
                if np.max(np.abs(self.flat[i] - self.flat[j])) < APART:
                    self.of[i] = self.of[j]
                    break
        self.weight: dict = {}
        members: dict = {}
        for i, leaf in enumerate(leaves):
            b = self.of[i]
            self.weight[b] = self.weight.get(b, 0.0) + leaf[0]
            members.setdefault(b, []).append(leaf[2])
        # a measurement's distribution on the way to a branch, where every
        # leaf of the branch had the same
        self.cond: dict = {}
        for b, conds in members.items():
            for name in conds[0]:
                ds = [c.get(name) for c in conds]
                if all(d is not None and np.max(np.abs(d - ds[0])) <= 1e-12
                       for d in ds):
                    self.cond[b, name] = ds[0]

    def assign(self, projections) -> np.ndarray:
        """The branch of each (P, 2, k) projected particle."""
        got = np.asarray(projections, np.float64).reshape(
            len(projections), -1)
        d = np.max(np.abs(got[:, None, :] - self.flat[None, :, :]), axis=2)
        return np.array([self.of[j] for j in np.argmin(d, axis=1)])


def draw_chi2(branches: Branches, assigned) -> float:
    """Pearson's χ² per degree of freedom of the branches the particles of
    every run ended in, pooled over the runs, against the branches'
    weights.  ``assigned``: each run's (branch of each particle, its
    log-weight); a particle counts P·w (1 where the weights are uniform).
    Branches expected to hold fewer than ``MIN_EXPECTED`` particles are
    pooled, smallest first, until every bin holds that many; with one bin
    there is nothing to test and it reads 0."""
    weight = branches.weight
    count = dict.fromkeys(weight, 0.0)
    for of, log_w in assigned:
        w = np.exp(log_w - np.max(log_w))
        w = len(w) * w / np.sum(w)
        for k, b in enumerate(of):
            count[b] += w[k]
    total = sum(count.values())
    mass = sum(weight.values())
    bins = sorted(weight, key=lambda b: weight[b])
    observed = [count[b] for b in bins]
    expected = [total * weight[b] / mass for b in bins]
    while len(expected) > 1 and expected[0] < MIN_EXPECTED:
        smallest = expected.pop(0)
        expected[0] += smallest
        smallest = observed.pop(0)
        observed[0] += smallest
        order = np.argsort(expected)
        expected = [expected[i] for i in order]
        observed = [observed[i] for i in order]
    if len(expected) < 2:
        return 0.0
    x2 = sum((o - e) ** 2 / e for o, e in zip(observed, expected))
    return float(x2 / (len(expected) - 1))


def judge(request, outputs: dict, device) -> dict:
    """Readings of the program's outputs against the enumerated branches.

    ``outputs``: ``psi`` (P, 2, 2^m) float32, ``log_w`` (P,) and
    ``lost_mass`` of the final ensemble of the run judged, ``readouts`` of
    that run ({measurement: distribution}) and ``run_readouts``, the
    readouts of every run of the window; of a sampled request also
    ``probe``, the (2^m, k) vectors the harness projected every run's
    final particles on, and ``projections``, each run's (P, 2, k)
    projections with its (P,) log-weights.

    - ``state_gap``: over the particles that carry weight (above 1e-9),
      the largest relative L2 distance from the nearest leaf;
    - ``weight_gap`` (exact fan-out): the largest difference between the
      weight the particles near a leaf state carry and the weight of the
      leaves of that state;
    - ``weight_spread`` (sampled): the largest |P·w − 1| (the Born
      proposal keeps weights uniform);
    - ``draw_chi2`` (sampled): :func:`draw_chi2`, whether the particles
      of all runs were drawn by Born weight, each told to be in its branch
      by its projections (:class:`Branches`);
    - ``readout_gap``: the largest difference of a readout's entry from the
      reference's: exact fan-out, each run's against the distributions over
      all branches; sampled, the first measurement of each run (drawn
      before any sampling) likewise, and each run's later readouts against
      the mean over its particles of their branches' distributions at that
      measurement, where the particles' branches fix them (leaves of one
      final state may have come by different outcomes);
    - ``particles``: sampled, |P − sample|;
    - ``lost_mass``: exact fan-out, the mass the program reports pruned;
    - ``trajectories``: exact fan-out, |branches of nonzero probability −
      the request's trajectories a run|.
    """
    leaves, ref_readouts = enumerate_branches(request, device)
    sampled = request.sample > 0
    log_w = outputs["log_w"].double().cpu()
    w = torch.softmax(log_w, dim=0)
    rows = torch.nonzero(w > WEIGHTED).reshape(-1)
    got = _planar_rows(outputs["psi"], rows, device)
    ref = torch.stack([leaf[1] for leaf in leaves])
    leaves = [(weight, None, conds) for weight, _, conds in leaves]
    # squared distances of every weighted particle from every leaf
    gram = got.conj() @ ref.T
    d2 = (torch.sum(torch.abs(got) ** 2, dim=1)[:, None]
          + torch.sum(torch.abs(ref) ** 2, dim=1)[None, :]
          - 2 * gram.real)
    nearest = torch.argmin(d2, dim=1)
    state_gap = 0.0
    for i in range(rows.shape[0]):
        leaf = ref[nearest[i]]
        gap = torch.linalg.vector_norm(got[i] - leaf) / \
            torch.linalg.vector_norm(leaf)
        state_gap = worst(state_gap, float(gap))
    del got, gram
    nearest = nearest.cpu().numpy()
    readings = {"state_gap": state_gap}

    first = next(e[1] for e in request.events if e[0] == "meas")
    readout_gap = 0.0
    for readouts in outputs["run_readouts"]:
        for name, dist in readouts.items():
            if sampled and name != first:
                continue
            readout_gap = worst(readout_gap, float(np.max(np.abs(
                np.asarray(dist) - ref_readouts[name]))))
    if sampled:
        P = outputs["log_w"].shape[0]
        readings["weight_spread"] = float(torch.max(torch.abs(P * w - 1.0)))
        branches = Branches(leaves, ref, outputs["probe"])
        assigned = [(branches.assign(proj), log_w)
                    for proj, log_w in outputs["projections"]]
        for readouts, (of, log_w) in zip(outputs["run_readouts"], assigned):
            p = np.exp(log_w - np.max(log_w))
            p = p / np.sum(p)
            for name, dist in readouts.items():
                conds = [branches.cond.get((b, name)) for b in of]
                if name == first or any(c is None for c in conds):
                    continue
                want = np.sum(p[:, None] * np.stack(conds), axis=0)
                readout_gap = worst(readout_gap, float(np.max(np.abs(
                    np.asarray(dist) - want))))
        readings["readout_gap"] = readout_gap
        readings["particles"] = float(abs(P - request.sample))
        readings["draw_chi2"] = draw_chi2(branches, assigned)
        return readings
    # leaves of one state, and the weight of the particles nearest them
    cluster = _clusters(ref)
    want: dict = {}
    have: dict = {}
    for i, leaf in enumerate(leaves):
        want[cluster[i]] = want.get(cluster[i], 0.0) + leaf[0]
    w_rows = w[rows].numpy()
    for i, j in enumerate(nearest):
        have[cluster[j]] = have.get(cluster[j], 0.0) + float(w_rows[i])
    weight_gap = 0.0
    for c in want:
        weight_gap = worst(weight_gap,
                           float(abs(have.get(c, 0.0) - want[c])))
    readings["weight_gap"] = weight_gap
    readings["readout_gap"] = readout_gap
    readings["lost_mass"] = float(outputs["lost_mass"])
    readings["trajectories"] = float(abs(
        len(leaves) - request.per_run["samples"]))
    return readings
