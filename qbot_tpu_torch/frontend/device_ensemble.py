"""Probabilistic control flow ON the device particle axis.

Port of :mod:`qbot_tpu.frontend.device_ensemble`
(``qbot_tpu/frontend/device_ensemble.py:53-195, 457-860``).
:mod:`qbot_tpu_torch.frontend.ensemble` runs ProbVal-conditioned control
flow with host-side dense density matrices; this module is its device
twin: the *classical* side of a particle (namespace, program counter,
weight) stays host-side Python, while its *quantum* register is a
:class:`~qbot_tpu_torch.inference.ensemble_exec.QuantumEnsemble` — a
weighted batch of planar pure states on the device (the CUDA card by
default).  A ProbVal-conditioned ``cjmp``/``halt``/``retr`` forks the host
particle; the forked branches SHARE the device tensors (no operation writes
them in place), so a fork costs no device work.  ProbVal-valued *operands*
(gate, targets, controls, conditional) fan out on the device particle axis
instead of mixing a dense ρ.

Supported surface: everything the host ensemble runner supports,
including targeted ``qset`` (replace-subset — reference
``replaceArbitrary`` — as a per-particle partial trace + tensor insert).
``meas``/``disc`` fan or sample device particles exactly like the lowered
mid-measurement path; a final merge mixes each branch's ensemble to a
density matrix and reuses the host runner's namespace merge, so
``executeTxtEnsemble`` and this runner return THE SAME merged namespace.

With ``mesh=`` (an :class:`~qbot_tpu_torch.tpu.sharding.EnsembleMesh`)
every quantum operation runs on the particle × qubit mesh
(:class:`_ShardedEngine`, ``qbot_tpu/frontend/device_ensemble.py:
196-455``): SPMD, every rank runs the program, its host particles and
branch forks in lockstep, each register's particles split over the mesh's
rows and its states over each row's qubit shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

import qbot_tpu_torch.errors as err
from qbot_tpu_torch.basis import Basis
from qbot_tpu_torch.frontend import operations as ops
from qbot_tpu_torch.frontend.ensemble import (
    MAX_PARTICLES,
    EnsembleResult,
    _clone_ns,
    _merge_particles,
    _truth_probability,
)
from qbot_tpu_torch.frontend.evaluation import evaluate_expr
from qbot_tpu_torch.frontend.interpreter import record_marks, tokenize_line
from qbot_tpu_torch.helpers import int_log2
from qbot_tpu_torch.probval import ProbVal

__all__ = ["execute_lines_device_ensemble", "executeTxtDeviceEnsemble"]

_QUANTUM_OPS = ("qset", "gate", "swap", "disc", "meas", "peek")


@dataclass
class _DeviceParticle:
    prob: float
    ns: dict
    line: int
    qreg: Optional[object] = None        # QuantumEnsemble | None
    n: int = 0                           # current register width
    done: bool = False




class _Engine:
    """Per-run device engine state (device, generator, knobs).

    The quantum-op executor :func:`_exec_quantum` talks to the engine only
    through this method surface.
    """

    def __init__(self, max_particles: int, window: int, collapse_mode: str,
                 sample: int, seed: int, device):
        from qbot_tpu_torch.inference import ensemble_exec as ee
        from qbot_tpu_torch.tpu import compiler

        self.ee = ee
        self.compiler = compiler
        self.device = torch.device(device)
        self.max_particles = max_particles
        self.window = window
        self.collapse_mode = collapse_mode
        self.sample = sample
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    # -- state construction -------------------------------------------------
    def init_pure(self, vec: np.ndarray):
        from qbot_tpu_torch.tpu.planar import to_planar
        return self.ee.init_ensemble(
            torch.from_numpy(to_planar(vec)).to(self.device))

    def init_mixed(self, rho: np.ndarray):
        return self.ee.init_mixed_ensemble(rho, device=self.device)

    def replicate(self, qreg):
        """SMC regime: replicate to the fixed population up front."""
        reps = max(1, self.sample // qreg.num_particles)
        return self.ee.QuantumEnsemble(
            torch.repeat_interleave(qreg.log_w, reps) - float(np.log(reps)),
            torch.repeat_interleave(qreg.psi, reps, dim=0), qreg.lost_mass)

    # -- unitaries ----------------------------------------------------------
    def apply_circuit(self, qreg, circ):
        plan = self.compiler.compile_circuit(circ, window=self.window)
        return self.ee.apply_plan_ensemble(qreg, plan)

    def one_gate(self, qreg, n, matrix, targets, controls):
        from qbot_tpu_torch.tpu.circuit import Circuit

        circ = Circuit(n)
        circ.gate(np.asarray(matrix, complex), list(targets), list(controls))
        return self.apply_circuit(qreg, circ)

    def rotate(self, qreg, n, basis, targets, inverse=False):
        """Basis rotation (B† per block, or its inverse) — None-safe."""
        from qbot_tpu_torch.frontend.lowering import _basis_rotation_plans

        rot, inv = _basis_rotation_plans(basis, list(targets), n,
                                         self.window)
        plan = inv if inverse else rot
        if plan is None:
            return qreg
        return self.ee.apply_plan_ensemble(qreg, plan)

    # -- collapse events ----------------------------------------------------
    def measure(self, qreg, n, targets):
        if self.sample:
            qreg, dist, _ = self.ee.measure_sample(self.gen, qreg, n,
                                                   targets)
            return qreg, dist
        return self.ee.measure_fanout(qreg, n, targets, self.max_particles,
                                      mode=self.collapse_mode)

    def discard(self, qreg, n, targets):
        if self.sample:
            return self.ee.discard_sample(self.gen, qreg, n, targets)
        return self.ee.discard_fanout(qreg, n, targets, self.max_particles)

    def peek(self, qreg, n, targets):
        return self.ee.peek_probs(qreg, n, targets)

    def replace(self, qreg, n, targets, new_states):
        """Targeted qset (reference ``replaceArbitrary`` semantics):
        partial-trace the targets out per particle and tensor the new
        state's eigen-branches back in at the same positions.  Sample
        mode draws ONE traced outcome + ONE new-state branch per
        particle (constant population)."""
        if self.sample:
            return self.ee.replace_sample(self.gen, qreg, n, list(targets),
                                          new_states)
        return self.ee.replace_fanout(qreg, n, list(targets), new_states,
                                      self.max_particles)

    # -- branch bookkeeping -------------------------------------------------
    def concat(self, weighted):
        """Weight-concatenate [(p, QuantumEnsemble)] into one ensemble.

        ``lost_mass`` is threaded through: a p-weighted mixture of
        ensembles with TV error bounds ε_i carries bound Σ p_i ε_i / Σ p_i,
        and any subsequent prune accumulates on top of that.  Sample
        mode resamples back down to the fixed population instead of the
        (biased) top-k prune.
        """
        if self.sample:
            B = min(q.num_particles for _, q in weighted)
            return self.ee.concat_resampled(self.gen, weighted, B)
        return self.ee.concat_weighted(weighted, self.max_particles)

    def mixture(self, qreg) -> np.ndarray:
        return self.ee.ensemble_mixture(qreg)

    def mixture_provider(self, qreg):
        """The lazy dense-field provider of a measurement result: the
        pre-measurement mixture, gathered on first access."""
        return lambda: self.mixture(qreg)

    def lost_mass(self, qreg) -> float:
        return float(qreg.lost_mass)


class _ShardedEngine(_Engine):
    """Mesh twin: a register's particles split over the mesh's rows and
    each state over its row's qubit shards
    (:mod:`qbot_tpu_torch.tpu.sharded_ensemble`).

    Every operation keeps the canonical identity qubit layout (appending
    :func:`~qbot_tpu_torch.tpu.sharded.plan_perm_to_identity` items after
    any plan that resharded), so ensembles of different program branches
    stay concatenable and outcome bits read in logical order.  Sampling
    draws from the row's generator (``row_generator(seed, mesh)``).
    """

    def __init__(self, max_particles, window, collapse_mode, sample, seed,
                 mesh):
        super().__init__(max_particles, window, collapse_mode, sample, seed,
                         mesh.device)
        from qbot_tpu_torch.tpu import sharded, sharded_ensemble as se

        self.se, self.sharded = se, sharded
        self.emesh = mesh
        self.k = mesh.k
        self.gen = se.row_generator(seed, mesh)

    def q_ok(self, n: int) -> bool:
        """Can an n-qubit register shard over the qubit axis?  Needs
        n − k >= k (``compile_sharded``'s guard); narrower registers are
        replicated over each row and parallelise on particles only."""
        return self.k > 0 and n - self.k >= self.k

    def _keff(self, n: int) -> int:
        return self.k if self.q_ok(n) else 0

    # -- state construction -------------------------------------------------
    def _place(self, psi, log_w, n: int, lost=0.0):
        ens = self.se.init_sharded_ensemble(psi, self.emesh, log_w=log_w,
                                            q_sharded=self.q_ok(n))
        return ens._replace(lost_mass=lost)

    def init_pure(self, vec: np.ndarray):
        from qbot_tpu_torch.tpu.planar import to_planar

        return self._place(to_planar(vec), None,
                           int_log2(np.asarray(vec).shape[0]))

    def init_mixed(self, rho: np.ndarray):
        from qbot_tpu_torch.tpu.planar import to_planar

        vals, vecs = np.linalg.eigh(np.asarray(rho, complex))
        keep = vals > 1e-12
        vals, vecs = vals[keep], vecs[:, keep]
        psi = np.stack([to_planar(vecs[:, i]) for i in range(vals.shape[0])])
        return self._place(psi, np.log(vals / vals.sum()),
                           int_log2(np.asarray(rho).shape[0]))

    def replicate(self, qreg):
        from qbot_tpu_torch.tpu.planar import to_planar

        w, kets = self.se.gather_ensemble(qreg, self.emesh)
        reps = max(1, self.sample // kets.shape[0])
        psi = np.repeat(np.stack([to_planar(kk) for kk in kets]), reps,
                        axis=0)
        lw = np.repeat(np.log(np.clip(w, 1e-300, None)), reps) - np.log(reps)
        return self._place(psi, lw, int_log2(kets.shape[-1]))

    # -- unitaries ----------------------------------------------------------
    def _run_items(self, qreg, n: int, items, perm):
        if not items:
            return qreg
        plan = self.sharded.ShardedPlan(n=n, k=self._keff(n),
                                        items=list(items), final_perm=perm)
        return self.se.apply_sharded_plan_ensemble(qreg, plan, self.emesh)

    def apply_circuit(self, qreg, circ):
        """Compile on the identity layout, run, restore the identity."""
        keff = self._keff(circ.n)
        splan = self.sharded.compile_sharded(circ, keff, window=self.window)
        fix, perm = self.sharded.plan_perm_to_identity(splan.final_perm,
                                                       circ.n, keff)
        return self._run_items(qreg, circ.n, list(splan.items) + fix, perm)

    def rotate(self, qreg, n, basis, targets, inverse=False):
        from qbot_tpu_torch.frontend.lowering import (
            _is_computational,
            _rotation_circuit,
        )

        if _is_computational(basis):
            return qreg
        return self.apply_circuit(qreg, _rotation_circuit(
            basis, sorted(targets), n, inverse))

    # -- collapse events ----------------------------------------------------
    def _layout(self, n, targets):
        """(shard positions, local axes) of sorted targets on the identity
        layout; the outcome bits are then in logical order."""
        keff = self._keff(n)
        targets = sorted(targets)
        return ([q for q in targets if q < keff],
                [q - keff for q in targets if q >= keff])

    def _localized(self, qreg, n, targets):
        """The register with ``targets`` made local: (qreg, perm, their
        local axes in ``targets``' order)."""
        keff = self._keff(n)
        items, perm = self.sharded.plan_reshards_to_localize(
            list(range(n)), n, keff, sorted(targets))
        qreg = self._run_items(qreg, n, items, perm)
        pos = [0] * n
        for p, q in enumerate(perm):
            pos[q] = p
        return qreg, perm, [pos[q] - keff for q in targets]

    def _restore(self, qreg, n, perm):
        items, out = self.sharded.plan_perm_to_identity(perm, n,
                                                        self._keff(n))
        return self._run_items(qreg, n, items, out)

    def measure(self, qreg, n, targets):
        targets = sorted(targets)
        q_s = self.q_ok(n)
        shard_pos, local = self._layout(n, targets)
        if self.sample:
            qreg, dist = self.se.measure_sample_sharded(
                self.gen, qreg, n, local, self.emesh,
                shard_positions=shard_pos, q_sharded=q_s)
            return qreg, dist
        mode = self.collapse_mode
        if mode == "reference" and shard_pos:
            if len(targets) == n:
                mode = "projective"      # identical semantics on all qubits
            else:
                from qbot_tpu_torch.frontend.lowering import (
                    _reorder_outcome_bits,
                )

                keff = self._keff(n)
                qreg, perm, _ = self._localized(qreg, n, targets)
                pos = [0] * n
                for p, q in enumerate(perm):
                    pos[q] = p
                local = sorted(pos[q] - keff for q in targets)
                phys_logicals = [perm[a + keff] for a in local]
                qreg, dist = self.se.measure_fanout_sharded(
                    qreg, n, local, self.emesh, self.max_particles,
                    mode=mode, q_sharded=q_s)
                qreg = self._restore(qreg, n, perm)
                return qreg, torch.from_numpy(_reorder_outcome_bits(
                    dist.cpu().numpy(), phys_logicals, targets))
        return self.se.measure_fanout_sharded(
            qreg, n, local, self.emesh, self.max_particles, mode=mode,
            shard_positions=shard_pos, q_sharded=q_s)

    def discard(self, qreg, n, targets):
        targets = sorted(targets)
        q_s = self.q_ok(n)
        qreg, perm, local = self._localized(qreg, n, targets)
        local = sorted(local)
        if self.sample:
            qreg = self.se.discard_sample_sharded(
                self.gen, qreg, n, local, self.emesh, q_sharded=q_s)
        else:
            qreg = self.se.discard_fanout_sharded(
                qreg, n, local, self.emesh, self.max_particles,
                q_sharded=q_s)
        removed = {perm.index(q) for q in targets}
        new_perm = [q - sum(1 for r in targets if r < q)
                    for p, q in enumerate(perm) if p not in removed]
        new_n = n - len(targets)
        if q_s and not self.q_ok(new_n):
            # the shrunk register no longer shards over the qubit axis:
            # gather it (at most 2^(2k-1) amplitudes a particle now), in
            # logical order, and place it replicated
            from qbot_tpu_torch.tpu.planar import to_planar

            w, kets = self.se.gather_ensemble(qreg, self.emesh, new_perm)
            return self._place(np.stack([to_planar(kk) for kk in kets]),
                               np.log(np.clip(w, 1e-300, None)), new_n,
                               qreg.lost_mass)
        return self._restore(qreg, new_n, new_perm)

    def peek(self, qreg, n, targets):
        shard_pos, local = self._layout(n, targets)
        return self.se.peek_probs_sharded(
            qreg, n, local, self.emesh, shard_positions=shard_pos,
            q_sharded=self.q_ok(n))

    def replace(self, qreg, n, targets, new_states):
        """Targeted qset on the mesh: localise, replace shard-locally (the
        layout stays), restore the identity layout."""
        q_s = self.q_ok(n)
        qreg, perm, local = self._localized(qreg, n, targets)
        if self.sample:
            qreg = self.se.replace_sample_sharded(
                self.gen, qreg, n, local, new_states, self.emesh,
                q_sharded=q_s)
        else:
            qreg = self.se.replace_fanout_sharded(
                qreg, n, local, new_states, self.emesh,
                self.max_particles, q_sharded=q_s)
        return self._restore(qreg, n, perm)

    # -- branch bookkeeping -------------------------------------------------
    def concat(self, weighted):
        cat = self.se.concat_sharded(weighted, self.emesh)
        if self.sample:
            B = min(q.num_particles for _, q in weighted)
            return self.se.resample_down_sharded(self.gen, cat, B,
                                                 self.emesh)
        return self.se.prune_sharded(cat, self.max_particles, self.emesh)

    def mixture(self, qreg) -> np.ndarray:
        return self.se.sharded_ensemble_mixture(qreg, self.emesh)

    def mixture_provider(self, qreg):
        """Gathered now, on every rank: a collective cannot wait for one
        rank's lazy read."""
        rho = self.mixture(qreg)
        return lambda: rho


def _to_density_host(lines, line_num, val):
    if isinstance(val, ProbVal):
        try:
            return val.to_density_matrix()
        except Exception:
            raise err.type_error(lines, line_num,
                                 ["np.ndarray", "ProbVal<np.ndarray>"],
                                 val.type_string()) from None
    arr = np.asarray(val)
    if arr.ndim == 1:
        return np.outer(arr, arr.conj())
    return arr


def _fanout_args(lines, line_num, *vals):
    """Cartesian branches [(prob, concrete_vals)] of possibly-ProbVal vals."""
    branches = [(1.0, [])]
    for v in vals:
        if isinstance(v, ProbVal):
            branches = [(p * bp, acc + [bv])
                        for p, acc in branches
                        for bp, bv in zip(v.probs, v.values)]
        else:
            branches = [(p, acc + [v]) for p, acc in branches]
    return branches


def _exec_quantum(engine: _Engine, particle: _DeviceParticle, lines,
                  line_num, tokens) -> None:
    """Run one quantum op against the particle's device register."""
    from qbot_tpu_torch.frontend.lowering import _make_result

    ns = particle.ns
    op_name = tokens[0]

    if op_name == "qset":
        if len(tokens) > 2:
            # TARGETED qset: replace a qubit subset in place (reference
            # replaceArbitrary, operators.py:133-166) — per-particle
            # partial trace + tensor insert on the device ensemble
            if particle.qreg is None:
                raise err.QbotScriptError(err.format_script_error(
                    lines, line_num, "DeviceEnsembleError",
                    "targeted qset before the register exists"),
                    line_num, "DeviceEnsembleError")
            from qbot_tpu_torch.frontend.lowering import _new_state_branches

            val = evaluate_expr(lines, line_num, tokens[1], ns)
            tgts = evaluate_expr(lines, line_num, tokens[2], ns)
            n = particle.n

            def tlist(tv):
                tl = [int(q) for q in ops._ensure_container(
                    lines, line_num, tv)]
                for q in tl:
                    if q < 0 or q >= n:
                        raise err.index_error(lines, line_num, "target",
                                              q, n - 1)
                return tl

            if isinstance(tgts, ProbVal):
                parts = []
                for p, tv in zip(tgts.probs, tgts.values):
                    tl = tlist(tv)
                    nb = _new_state_branches(lines, line_num, val, len(tl))
                    parts.append((float(p),
                                  engine.replace(particle.qreg, n, tl, nb)))
                particle.qreg = engine.concat(parts)
            else:
                tl = tlist(tgts)
                nb = _new_state_branches(lines, line_num, val, len(tl))
                particle.qreg = engine.replace(particle.qreg, n, tl, nb)
            ns["__updated_state"] = True
            return
        val = evaluate_expr(lines, line_num, tokens[1], ns)
        rho = _to_density_host(lines, line_num, val)
        particle.n = int_log2(rho.shape[0])
        vals, vecs = np.linalg.eigh(rho)
        if np.isclose(vals[-1], np.trace(rho).real, atol=1e-9):
            # pure state: a single particle, no mixture
            particle.qreg = engine.init_pure(vecs[:, -1])
        else:
            particle.qreg = engine.init_mixed(rho)
        if engine.sample:
            particle.qreg = engine.replicate(particle.qreg)
        ns["__is_q_state"] = True
        ns["__updated_state"] = True
        return

    if particle.qreg is None:
        raise err.QbotScriptError(err.format_script_error(
            lines, line_num, "DeviceEnsembleError",
            f"{op_name} before qset"), line_num, "DeviceEnsembleError")
    n = particle.n

    if op_name == "gate":
        g = evaluate_expr(lines, line_num, tokens[1], ns)
        first = (evaluate_expr(lines, line_num, tokens[2], ns)
                 if len(tokens) > 2 else 0)
        ops._check_probval_type(lines, line_num, first, ops._INT_TYPES)
        controls = (ops._ensure_container(
            lines, line_num, evaluate_expr(lines, line_num, tokens[3], ns))
            if len(tokens) > 3 else [])
        cond = (evaluate_expr(lines, line_num, tokens[4], ns)
                if len(tokens) > 4 else True)
        ops._check_probval_type(lines, line_num, cond, bool)
        if not isinstance(cond, ProbVal) and not cond:
            return

        weighted = []
        for p, (gv, fv, cv) in _fanout_args(lines, line_num, g, first,
                                            controls):
            gm = np.asarray(gv)
            k = int_log2(gm.shape[0])
            last = int(fv) + k - 1
            if fv < 0 or last > n - 1:
                raise err.index_error(lines, line_num, "target", int(fv),
                                      n - k)
            ctrls = list(cv)
            for c in ctrls:
                if c < 0 or c > n - 1:
                    raise err.index_error(lines, line_num, "control", c,
                                          n - 1)
                if fv <= c <= last:
                    raise err.control_target_overlap(lines, line_num, c,
                                                     int(fv), last)
            applied = engine.one_gate(particle.qreg, n, gm,
                                      range(int(fv), int(fv) + k), ctrls)
            weighted.append((p, applied))
        mixed = (weighted[0][1] if len(weighted) == 1
                 else engine.concat(weighted))
        if isinstance(cond, ProbVal):
            p_true, p_false = _truth_probability(cond, lines, line_num)
            # reference semantics: a ProbVal conditional MIXES applied and
            # unapplied states (operators.py:323-327) — on the particle
            # axis that is a weight-concat, not a host fork
            mixed = engine.concat([(max(p_true, 1e-300), mixed),
                                   (max(p_false, 1e-300), particle.qreg)])
        particle.qreg = mixed
        return

    if op_name == "swap":
        a = evaluate_expr(lines, line_num, tokens[1], ns)
        b = evaluate_expr(lines, line_num, tokens[2], ns)
        ops._check_probval_type(lines, line_num, a, ops._INT_TYPES)
        ops._check_probval_type(lines, line_num, b, ops._INT_TYPES)
        SWAP2 = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                          [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)
        weighted = []
        for p, (av, bv) in _fanout_args(lines, line_num, a, b):
            for q in (av, bv):
                if q < 0 or q >= n:
                    raise err.index_error(lines, line_num, "target", int(q),
                                          n - 1)
            if av == bv:
                weighted.append((p, particle.qreg))
            else:
                weighted.append((p, engine.one_gate(
                    particle.qreg, n, SWAP2, [int(av), int(bv)], [])))
        particle.qreg = (weighted[0][1] if len(weighted) == 1
                         else engine.concat(weighted))
        return

    if op_name == "disc":
        targets = ops._ensure_container(
            lines, line_num, evaluate_expr(lines, line_num, tokens[1], ns))
        if isinstance(targets, ProbVal):
            # ProbVal target sets (qbot/operators.py:
            # 169-188 via funcWrapper): equal-size branches MIX into one
            # register on the particle axis (the reference folds the
            # fan-out to one ρ); differing sizes cannot share a batch, so
            # they fork HOST particles and merge as a ProbVal state
            branch_sets = []
            for p, tv in zip(targets.probs, targets.values):
                tset = sorted(set(int(q) for q in ops._ensure_container(
                    lines, line_num, tv)))
                ops._check_targets_in_range(lines, line_num, tset, n)
                branch_sets.append((float(p), tset))
            sizes = {len(t) for _, t in branch_sets}
            if len(sizes) != 1:
                # differing widths cannot fold into one register — the
                # reference's own toDensityMatrix fails on mixed shapes,
                # and the dense front-end renders the same type error
                raise err.type_error(lines, line_num,
                                     ["np.ndarray", "ProbVal<np.ndarray>"],
                                     "ProbVal<ndarray>")
            particle.qreg = engine.concat(
                [(p, engine.discard(particle.qreg, n, tset))
                 for p, tset in branch_sets])
            particle.n = n - sizes.pop()
            return
        targets = sorted(set(int(q) for q in targets))
        ops._check_targets_in_range(lines, line_num, targets, n)
        particle.qreg = engine.discard(particle.qreg, n, targets)
        particle.n = n - len(targets)
        return

    # meas / peek
    name = tokens[1]
    if not name.isidentifier():
        raise err.invalid_variable_name(lines, line_num, name)
    basis = evaluate_expr(lines, line_num, tokens[2], ns)
    if not isinstance(basis, Basis):
        raise err.type_error(lines, line_num, ["Basis"],
                             type(basis).__name__)
    targets = sorted(range(n)) if len(tokens) < 4 else sorted(set(
        int(q) for q in ops._ensure_container(
            lines, line_num,
            evaluate_expr(lines, line_num, tokens[3], ns))))
    ops._check_targets_in_range(lines, line_num, targets, n)
    # lazy dense-field provider: the pre-measurement mixture, gathered on
    # first .newState/.basisDensity access (clear error at large n)
    from qbot_tpu_torch.frontend.lowering import (
        _DENSE_REPLAY_LIMIT,
        _too_large_provider,
    )

    if n <= _DENSE_REPLAY_LIMIT:
        provider = engine.mixture_provider(particle.qreg)
    else:
        provider = _too_large_provider(n)
    qreg = engine.rotate(particle.qreg, n, basis, targets)
    if op_name == "meas":
        qreg, dist = engine.measure(qreg, n, targets)
        particle.qreg = engine.rotate(qreg, n, basis, targets, inverse=True)
    else:
        dist = engine.peek(qreg, n, targets)
    ns[name] = _make_result(basis, targets, dist.cpu().numpy(),
                            provider=provider)


def _step_device_particle(engine: _Engine, particle: _DeviceParticle,
                          lines) -> list[_DeviceParticle]:
    """Run until halt/split/end; mirrors ensemble._step_particle with the
    quantum ops routed to the device engine."""
    ns = particle.ns
    line_num = particle.line - 1
    while line_num < len(lines) - 1:
        line_num += 1
        tokens = tokenize_line(lines[line_num])
        if not tokens:
            continue
        op_name = tokens[0]
        if op_name in ("note", "mark"):
            continue
        try:
            op, min_args, max_args = ops.OPERATIONS[op_name]
        except KeyError:
            raise err.unknown_operation(lines, line_num, op_name) from None
        num_args = len(tokens) - 1
        if num_args < min_args or num_args > max_args:
            raise err.num_arguments_error(lines, line_num, op_name, num_args,
                                          min_args, max_args)

        if op_name in _QUANTUM_OPS:
            forked = _exec_quantum(engine, particle, lines, line_num,
                                   tokens)
            if forked:
                return forked            # ProbVal disc fan-out
            continue

        if op_name in ("cjmp", "halt", "retr"):
            has_cond = num_args >= (2 if op_name == "cjmp" else 1)
            cond = True
            if has_cond:
                cond_token = tokens[2] if op_name == "cjmp" else tokens[1]
                cond = evaluate_expr(lines, line_num, cond_token, ns)
            if isinstance(cond, ProbVal):
                p_true, p_false = _truth_probability(cond, lines, line_num)
                children = []

                def _spawn(prob, target_line, clone, done=False,
                           prev_jump=None):
                    child_ns = _clone_ns(ns) if clone else ns
                    if prev_jump is not None:
                        child_ns["__prev_jump"] = prev_jump
                    # the device register is immutable: children share it
                    children.append(_DeviceParticle(
                        particle.prob * prob, child_ns, target_line,
                        particle.qreg, particle.n, done))

                if op_name == "cjmp":
                    taken = ops._mark_line(ns, lines, line_num, tokens[1])
                    if p_true > 0:
                        _spawn(p_true, taken, clone=p_false > 0,
                               prev_jump=line_num)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                elif op_name == "halt":
                    if p_true > 0:
                        _spawn(p_true, line_num + 1, clone=p_false > 0,
                               done=True)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                else:  # retr
                    if p_true > 0:
                        _spawn(p_true, ns["__prev_jump"] + 1,
                               clone=p_false > 0)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                return children
            if not isinstance(cond, bool):
                raise err.type_error(lines, line_num, ["bool"],
                                     type(cond).__name__)
            if op_name == "cjmp":
                target = ops._mark_line(ns, lines, line_num, tokens[1])
                if cond:
                    ns["__prev_jump"] = line_num
                    line_num = target - 1
                continue
            if op_name == "halt":
                if cond:
                    break
                continue
            if cond:                     # retr
                line_num = ns["__prev_jump"]
            continue

        result = op(ns, lines, line_num, tokens)
        if result is None:
            continue
        if result.halt:
            break
        if result.jump_line is not None:
            line_num = result.jump_line - 1

    particle.done = True
    return [particle]


def execute_lines_device_ensemble(lines: list[str],
                                  max_particles: int = MAX_PARTICLES,
                                  window: int = 7,
                                  collapse_mode: str = "reference",
                                  sample: int = 0,
                                  seed: int = 0,
                                  prune_tol: float = 1e-6,
                                  mesh=None, device="cuda"):
    """Run a program with probabilistic control flow on the device engine.

    Returns (EnsembleResult, finished _DeviceParticles).  The merged
    namespace binds ``state`` to the branch-weighted mixture — identical to
    :func:`qbot_tpu_torch.frontend.ensemble.execute_lines_ensemble`'s contract —
    while the per-branch device ensembles stay available on the particles.

    The device registers live on ``device`` (default the CUDA card; the
    tests pass ``"cpu"``, which runs the kernels' plain versions), and
    sampling mode (``sample > 0``) draws from a :class:`torch.Generator`
    there seeded by ``seed``.  ``mesh``, this rank's
    :class:`~qbot_tpu_torch.tpu.sharding.EnsembleMesh`, runs every quantum
    operation on the particle × qubit mesh (its ranks' device in place of
    ``device``); every rank of it calls this function with the same
    program, and every rank returns the same merged namespace.
    """
    if mesh is not None:
        engine = _ShardedEngine(max_particles, window, collapse_mode, sample,
                                seed, mesh)
    else:
        engine = _Engine(max_particles, window, collapse_mode, sample, seed,
                         device)
    ns = {"state": None, "__updated_state": False, "__marks": {},
          "__prev_jump": -1}
    record_marks(ns, lines)

    live = [_DeviceParticle(1.0, ns, 0)]
    finished: list[_DeviceParticle] = []
    while live:
        particle = live.pop()
        for c in _step_device_particle(engine, particle, lines):
            (finished if c.done else live).append(c)
        if len(live) + len(finished) > max_particles:
            raise RuntimeError(
                f"probabilistic branching exceeded {max_particles} "
                f"particles; raise max_particles")

    # bind each branch's dense mixture so the host merge applies verbatim
    from qbot_tpu_torch.ops.core import empty_state
    for p in finished:
        p.ns["state"] = (engine.mixture(p.qreg)
                         if p.qreg is not None else empty_state())
    merged = _merge_particles(finished)
    # cumulative pruned-mass bound across branches: a prob-weighted mixture
    # of ensembles with TV bounds ε_i carries bound Σ prob_i·ε_i — surfaced
    # exactly like run_lowered_ensemble (lowering.py) so --compile
    # --ensemble never drops mass silently
    total_p = sum(p.prob for p in finished) or 1.0
    lost = sum(p.prob * engine.lost_mass(p.qreg)
               for p in finished if p.qreg is not None) / total_p
    from qbot_tpu_torch.frontend.lowering import warn_lost_mass

    warn_lost_mass(lost, prune_tol)
    return EnsembleResult(merged, [p.prob for p in finished],
                          [p.ns for p in finished], lost), finished


def executeTxtDeviceEnsemble(text: str,
                             max_particles: int = MAX_PARTICLES,
                             **kw) -> dict:
    """Device-engine twin of ``executeTxtEnsemble`` (same merged contract)."""
    res, _ = execute_lines_device_ensemble(text.splitlines(),
                                           max_particles, **kw)
    return res.namespace
