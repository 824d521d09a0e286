"""Lowering: compile .qb programs to circuit IR, and run them on the
PyTorch planar executor.

A copy of the host part of :mod:`qbot_tpu.frontend.lowering`
(``qbot_tpu/frontend/lowering.py:40-611, 850-882``): the program runs
through the normal front end (expressions, marks, classical control flow;
loops simply unroll) but *records* the unitary schedule into a
:class:`~qbot_tpu_torch.tpu.circuit.Circuit` instead of mutating a dense
host-side density matrix.  :func:`run_lowered` is the port of
``qbot_tpu.frontend.lowering.run_lowered`` on its planar route
(``qbot_tpu/frontend/lowering.py:1702-1767``), :func:`run_lowered_ensemble`
of its mid-measurement runner on the device ensemble (:614-847),
:func:`run_lowered_sharded` of its qubit-sharded runner (:1646-1700) on the
ranks of a ``torch.distributed`` mesh (:mod:`qbot_tpu_torch.tpu.sharded`),
and :func:`run_lowered_sharded_ensemble` of its mid-measurement runner on a
particle × qubit mesh (:979-1643,
:mod:`qbot_tpu_torch.tpu.sharded_ensemble`).

Lowerable surface: an initial pure-product ``qset``, then ``gate``/``swap``
with concrete (non-ProbVal) operands, classical ops (``cdef``, ``pydo``,
``cout``, ``jump``/``cjmp``/``retr``/``halt`` on classical conditions), and
a final ``meas``/``peek`` in any product basis.  Mixing ops (``disc``,
mid-circuit ``meas``, ProbVal operands) are outside the unitary fragment
and raise a lowering error naming the line.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

import qbot_tpu_torch.errors as err
from qbot_tpu_torch.basis import Basis
from qbot_tpu_torch.frontend import operations as ops
from qbot_tpu_torch.frontend.evaluation import evaluate_expr
from qbot_tpu_torch.frontend.interpreter import record_marks, tokenize_line
from qbot_tpu_torch.helpers import int_log2
from qbot_tpu_torch.ops.measurement import MeasurementResult
from qbot_tpu_torch.probval import ProbVal
from qbot_tpu_torch.tpu import simulator
from qbot_tpu_torch.tpu.circuit import Circuit
from qbot_tpu_torch.tpu.compiler import Plan, compile_circuit
from qbot_tpu_torch.tpu.planar import (
    apply_plan_planar,
    planar_probs,
    product_state_planar,
)
from qbot_tpu_torch.utils import profiling

__all__ = ["LoweredProgram", "LoweringError", "lower_program",
           "run_lowered", "run_lowered_ensemble", "run_lowered_sharded",
           "run_lowered_sharded_ensemble", "finish_lowered", "MeasSpec"]


class LoweringError(err.QbotScriptError):
    """The program steps outside the unitary fragment."""


class _PendingOutcomeUse(Exception):
    """A classical expression touched a not-yet-available outcome."""


class PendingOutcome:
    """Placeholder bound for a mid-circuit measurement result during
    segmented lowering: any use before the end of the quantum program
    signals the lowering loop (which either starts the epilogue there or
    rejects the program)."""

    def __init__(self, name: str):
        object.__setattr__(self, "_name", name)

    def _blow(self):
        raise _PendingOutcomeUse(object.__getattribute__(self, "_name"))

    def __getattr__(self, item):
        self._blow()

    def __getitem__(self, item):
        self._blow()

    def __bool__(self):
        self._blow()

    def __repr__(self):
        self._blow()


@dataclass(frozen=True)
class MeasSpec:
    """A mid-circuit measurement: where in the op stream, what, and how."""
    name: str
    basis: Basis
    targets: tuple[int, ...]
    collapse: bool                       # meas collapses; peek does not
    at_op: int                           # circuit op index it sits before


@dataclass(frozen=True)
class QSetSpec:
    """A mid-circuit TARGETED ``qset``: replace the ``targets`` qubits
    with a new state (reference semantics
    qbot/operators.py:133-166 via
    ``density.replaceArbitrary``; new-state qubit j lands on
    ``targets[j]``, order preserved).  The register width is unchanged.

    ``new_states``: ((weight, planar 2×2^t ket), …) — the eigen-branches
    of the (possibly mixed / ProbVal-folded) new state.

    ``branches``: for ProbVal target sets (all the same size), the
    (probability, target-list) fan-out; empty for plain targets.
    """
    targets: tuple[int, ...]
    new_states: tuple
    at_op: int
    branches: tuple = ()


@dataclass(frozen=True)
class DiscSpec:
    """A mid-circuit ``disc``: trace the targets out; the register shrinks.

    Later ops in the stream use post-discard qubit numbering (reference
    semantics: qbot/operators.py:169-188).

    ``branches``: for ProbVal target sets (all the SAME size, so the
    shrunk register width is well-defined on the lowered plan), the
    (probability, target-set) fan-out — executed as a weighted mixture of
    per-branch discards.  Empty for plain targets.
    """
    targets: tuple[int, ...]
    at_op: int
    branches: tuple = ()


@dataclass
class LoweredProgram:
    circuit: Circuit
    initial_kets: list[np.ndarray]          # tensor factors of |ψ₀⟩
    measure_basis: Optional[Basis] = None
    measure_targets: Optional[list[int]] = None
    measure_name: Optional[str] = None
    namespace: dict = field(default_factory=dict)
    lines: list[str] = field(default_factory=list)
    resume_line: int = -1                   # first line after the final meas
    # segmented (mid_measure) mode: every measurement/discard in op-stream
    # order (a chronological list of MeasSpec | DiscSpec)
    mid_measurements: list = field(default_factory=list)
    # mixed-state preparation (mid_measure mode): the full initial ρ, run
    # as its eigendecomposition ensemble (initial_kets is empty then)
    initial_density: Optional[np.ndarray] = None
    # the device ensemble's initial planar state, kept by
    # _initial_planar: (device, [initial_kets, *initial_kets], state)
    _init_planar: Optional[tuple] = field(default=None, init=False,
                                          repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.circuit.n

    @property
    def has_epilogue(self) -> bool:
        """True when classical ops follow the final measurement."""
        from qbot_tpu_torch.frontend.interpreter import peek_opcode
        if self.resume_line < 0:
            return False
        return any(peek_opcode(l) not in ("", "note", "mark")
                   for l in self.lines[self.resume_line:])


def _unsupported(lines, line_num, what):
    return LoweringError(err.format_script_error(
        lines, line_num, "LoweringError",
        f"{what} is outside the unitary fragment - run this program with "
        f"the dense interpreter instead"), line_num, "LoweringError")


def _as_product_kets(lines, line_num, val) -> list[np.ndarray]:
    """Decompose a state-prep operand into 1-or-more pure tensor factors."""
    if isinstance(val, ProbVal):
        raise _unsupported(lines, line_num, "ProbVal state preparation")
    arr = np.asarray(val)
    if arr.ndim == 1:
        return [arr.astype(complex)]
    # density matrix: accept only pure states (rank-1)
    vals, vecs = np.linalg.eigh(arr)
    top = int(np.argmax(vals))
    if not np.isclose(vals[top], np.trace(arr).real, atol=1e-9):
        raise _unsupported(lines, line_num, "mixed-state preparation")
    return [vecs[:, top].astype(complex)]


def _new_state_branches(lines, line_num, val, t: int):
    """((weight, planar 2×2^t ket), …) eigen-branches of a qset value.

    Accepts a ket, a density matrix, or a ProbVal of either (folded to
    one mixture first — reference funcWrapper fan-out then
    densityEnsambleToDensity, operators.py:160-166)."""
    from qbot_tpu_torch.tpu.planar import to_planar

    if isinstance(val, ProbVal):
        try:
            val = val.to_density_matrix()
        except Exception:
            raise _unsupported(lines, line_num,
                               "ProbVal qset value") from None
    arr = np.asarray(val, complex)
    dim = 2 ** t
    if arr.ndim == 1:
        if arr.shape[0] != dim:
            raise err.size_error(
                lines, line_num,
                f"qset state has dim {arr.shape[0]}, expected 2^{t} "
                f"= {dim} for {t} targets")
        return ((1.0, to_planar(arr / np.linalg.norm(arr))),)
    if arr.shape != (dim, dim):
        raise err.size_error(
            lines, line_num,
            f"qset state has shape {arr.shape}, expected ({dim}, {dim}) "
            f"for {t} targets")
    arr = arr / np.trace(arr).real
    vals, vecs = np.linalg.eigh(arr)
    return tuple((float(v), to_planar(vecs[:, i]))
                 for i, v in enumerate(vals) if v > 1e-12)


def lower_program(text: str, mid_measure: bool = False) -> LoweredProgram:
    """Lower a .qb program to circuit IR.

    Default mode: lowering stops at the first ``meas``/``peek`` (single
    final measurement; classical epilogue deferred to execution).

    ``mid_measure=True``: measurements become :class:`MeasSpec` markers in
    the op stream and lowering continues — for the device ensemble
    executor, which fans particles out at each collapse.  Classical uses of
    an outcome are only legal once no quantum ops remain (they start the
    epilogue); using one earlier raises, since outcome-dependent classical
    control flow needs the dense interpreter.
    """
    lines = text.splitlines()
    ns: dict = {"state": None, "__marks": {}, "__prev_jump": -1}
    record_marks(ns, lines)

    circuit: Optional[Circuit] = None
    initial_kets: list[np.ndarray] = []
    initial_density: Optional[np.ndarray] = None
    measured: Optional[tuple] = None
    mid_specs: list = []
    resume_line = -1
    n = 0          # initial register width
    cur_n = 0      # current width (shrinks at disc in mid_measure mode)

    line_num = -1
    while line_num < len(lines) - 1:
        line_num += 1
        tokens = tokenize_line(lines[line_num])
        if not tokens:
            continue
        op_name = tokens[0]
        if op_name in ("note", "mark"):
            continue
        if op_name not in ops.OPERATIONS:
            raise err.unknown_operation(lines, line_num, op_name)
        n_args = len(tokens) - 1
        _, lo, hi = ops.OPERATIONS[op_name]
        if n_args < lo or n_args > hi:
            raise err.num_arguments_error(lines, line_num, op_name, n_args,
                                          lo, hi)

        if op_name == "qset":
            if circuit is not None:
                # TARGETED qset mid-program: replace a qubit subset
                # (register width unchanged) — a QSetSpec collapse event
                # on the ensemble runners
                if not mid_measure or len(tokens) < 3:
                    raise _unsupported(lines, line_num, "mid-circuit qset")
                val = evaluate_expr(lines, line_num, tokens[1], ns)
                tgts = evaluate_expr(lines, line_num, tokens[2], ns)

                def _qset_targets(tv):
                    tl = [int(q) for q in ops._ensure_container(
                        lines, line_num, tv)]
                    for q in tl:
                        if q < 0 or q >= cur_n:
                            raise err.index_error(lines, line_num,
                                                  "target", q, cur_n - 1)
                    if len(set(tl)) != len(tl):
                        raise _unsupported(lines, line_num,
                                           "duplicate qset targets")
                    return tuple(tl)

                if isinstance(tgts, ProbVal):
                    branches = []
                    sizes = set()
                    for p, tv in zip(tgts.probs, tgts.values):
                        tl = _qset_targets(tv)
                        sizes.add(len(tl))
                        branches.append((float(p), tl))
                    if len(sizes) != 1:
                        raise _unsupported(
                            lines, line_num,
                            "ProbVal qset targets with differing sizes")
                    t = sizes.pop()
                    mid_specs.append(QSetSpec(
                        branches[0][1],
                        _new_state_branches(lines, line_num, val, t),
                        len(circuit.ops), tuple(branches)))
                else:
                    tl = _qset_targets(tgts)
                    mid_specs.append(QSetSpec(
                        tl, _new_state_branches(lines, line_num, val,
                                                len(tl)),
                        len(circuit.ops)))
                continue
            val = evaluate_expr(lines, line_num, tokens[1], ns)
            if len(tokens) > 2:
                raise _unsupported(lines, line_num,
                                   "targeted qset before the register "
                                   "exists")
            if mid_measure:
                # the ensemble executor preps ANY ρ (ProbVal branches fold
                # to a mixture, mixed states run as their eigenensemble)
                if isinstance(val, ProbVal):
                    try:
                        val = val.to_density_matrix()
                    except Exception:
                        raise _unsupported(lines, line_num,
                                           "ProbVal state preparation") \
                            from None
                try:
                    initial_kets = _as_product_kets(lines, line_num, val)
                except LoweringError:
                    arr = np.asarray(val, complex)
                    initial_kets = []
                    initial_density = arr
                    n = cur_n = int_log2(arr.shape[0])
                    circuit = Circuit(n)
                    continue
            else:
                initial_kets = _as_product_kets(lines, line_num, val)
            n = cur_n = sum(int_log2(k.shape[0]) for k in initial_kets)
            circuit = Circuit(n)
            continue

        if op_name == "gate":
            if circuit is None:
                raise _unsupported(lines, line_num, "gate before qset")
            g = evaluate_expr(lines, line_num, tokens[1], ns)
            if isinstance(g, ProbVal):
                raise _unsupported(lines, line_num, "ProbVal gate")
            first = 0
            if len(tokens) > 2:
                first = evaluate_expr(lines, line_num, tokens[2], ns)
                if not isinstance(first, (int, np.integer)):
                    raise _unsupported(lines, line_num, "non-int target")
            controls = []
            if len(tokens) > 3:
                controls = ops._ensure_container(
                    lines, line_num,
                    evaluate_expr(lines, line_num, tokens[3], ns))
                if isinstance(controls, ProbVal):
                    raise _unsupported(lines, line_num, "ProbVal controls")
            if len(tokens) > 4:
                cond = evaluate_expr(lines, line_num, tokens[4], ns)
                if isinstance(cond, ProbVal):
                    raise _unsupported(lines, line_num, "ProbVal conditional")
                if not cond:
                    continue
            g = np.asarray(g)
            k = int_log2(g.shape[0])
            targets = list(range(int(first), int(first) + k))
            for q in targets + list(controls):
                if q < 0 or q >= cur_n:
                    raise err.index_error(lines, line_num, "target", q,
                                          cur_n - 1)
            circuit.gate(g, targets, list(controls))
            continue

        if op_name == "swap":
            if circuit is None:
                raise _unsupported(lines, line_num, "swap before qset")
            a = evaluate_expr(lines, line_num, tokens[1], ns)
            b = evaluate_expr(lines, line_num, tokens[2], ns)
            if isinstance(a, ProbVal) or isinstance(b, ProbVal):
                raise _unsupported(lines, line_num, "ProbVal swap targets")
            if a != b:
                circuit.swap(int(a), int(b))
            continue

        if op_name in ("meas", "peek"):
            if circuit is None:
                raise _unsupported(lines, line_num, "measurement before qset")
            basis = evaluate_expr(lines, line_num, tokens[2], ns)
            if not isinstance(basis, Basis):
                raise err.type_error(lines, line_num, ["Basis"],
                                     type(basis).__name__)
            targets = list(range(cur_n))
            if len(tokens) > 3:
                targets = ops._ensure_container(
                    lines, line_num,
                    evaluate_expr(lines, line_num, tokens[3], ns))
                if isinstance(targets, ProbVal):
                    raise _unsupported(lines, line_num, "ProbVal targets")
                targets = sorted(set(targets))
            if len(targets) % basis.numQubits:
                raise LoweringError(err.format_script_error(
                    lines, line_num, "MeasurementIndexError",
                    f"{len(targets)} measurement targets do not divide "
                    f"into {basis.numQubits}-qubit basis blocks"),
                    line_num, "MeasurementIndexError")
            if mid_measure:
                mid_specs.append(MeasSpec(tokens[1], basis, tuple(targets),
                                          op_name == "meas",
                                          len(circuit.ops)))
                ns[tokens[1]] = PendingOutcome(tokens[1])
                continue
            measured = (basis, targets, tokens[1])
            # lowering stops here: the classical epilogue runs AFTER device
            # execution, with the measurement result bound (finish_lowered)
            resume_line = line_num + 1
            break

        if op_name == "disc":
            if not mid_measure:
                raise _unsupported(lines, line_num, "disc (non-unitary)")
            if circuit is None:
                raise _unsupported(lines, line_num, "disc before qset")
            targets = ops._ensure_container(
                lines, line_num,
                evaluate_expr(lines, line_num, tokens[1], ns))
            if isinstance(targets, ProbVal):
                # ProbVal target sets fan into weighted particles at
                # execution — lowerable iff every branch discards the
                # SAME number of qubits (the shrunk register must have
                # one width on a compiled plan; differing sizes need the
                # dense interpreter or the device-ensemble runner)
                branches = []
                sizes = set()
                for p, tv in zip(targets.probs, targets.values):
                    tset = sorted(set(int(q) for q in ops._ensure_container(
                        lines, line_num, tv)))
                    for q in tset:
                        if q < 0 or q >= cur_n:
                            raise err.index_error(lines, line_num,
                                                  "target", q, cur_n - 1)
                    sizes.add(len(tset))
                    branches.append((float(p), tuple(tset)))
                if len(sizes) != 1:
                    raise _unsupported(
                        lines, line_num,
                        "ProbVal disc targets with differing sizes")
                mid_specs.append(DiscSpec(branches[0][1],
                                          len(circuit.ops),
                                          tuple(branches)))
                cur_n -= sizes.pop()
                continue
            targets = sorted(set(int(q) for q in targets))
            for q in targets:
                if q < 0 or q >= cur_n:
                    raise err.index_error(lines, line_num, "target", q,
                                          cur_n - 1)
            mid_specs.append(DiscSpec(tuple(targets), len(circuit.ops)))
            cur_n -= len(targets)
            continue

        # classical ops run normally (control flow unrolls)
        op, _, _ = ops.OPERATIONS[op_name]
        try:
            result = op(ns, lines, line_num, tokens)
        except (_PendingOutcomeUse, err.QbotScriptError) as e:
            pending = (e if isinstance(e, _PendingOutcomeUse)
                       else getattr(e, "__cause__", None))
            if not isinstance(pending, _PendingOutcomeUse):
                raise
            # a classical op touched a measurement outcome: legal only if
            # the rest of the program is classical — it becomes the
            # epilogue, executed after device measurement results bind
            for ln in range(line_num, len(lines)):
                from qbot_tpu_torch.frontend.interpreter import peek_opcode
                if peek_opcode(lines[ln]) in _EPILOGUE_FORBIDDEN:
                    raise _unsupported(
                        lines, line_num,
                        "classical use of a measurement outcome before "
                        "later quantum operations") from None
            resume_line = line_num
            break
        if result is None:
            continue
        if result.halt:
            break
        if result.jump_line is not None:
            line_num = result.jump_line - 1

    if circuit is None:
        circuit = Circuit(0)
    lp = LoweredProgram(circuit, initial_kets, namespace=ns, lines=lines,
                        resume_line=resume_line,
                        mid_measurements=mid_specs,
                        initial_density=initial_density)
    if measured is not None:
        lp.measure_basis, lp.measure_targets = measured[0], measured[1]
        lp.measure_name = measured[2]
    return lp


_EPILOGUE_FORBIDDEN = ("qset", "gate", "swap", "meas", "peek", "disc")


_DENSE_REPLAY_LIMIT = 12      # max qubits gathered to replay dense fields


def _make_result(basis: Basis, targets, probs, provider=None):
    """MeasurementResult from an outcome distribution (interpreter-format).

    ``provider`` (no-arg callable returning the dense pre-measurement ρ,
    or raising) upgrades the result to a :class:`DeviceMeasurementResult`
    whose state fields materialise lazily (VERDICT r3 weak #6)."""
    from qbot_tpu_torch.ops.measurement import MeasurementResult, _digits_big_endian

    m = len(targets) // basis.numQubits
    symbols = ["".join(basis.ketSymbols[d]
                       for d in _digits_big_endian(i, len(basis), m))
               for i in range(len(probs))]
    if provider is not None:
        return DeviceMeasurementResult([float(p) for p in probs], symbols,
                                       basis, list(targets), provider)
    return MeasurementResult(None, [float(p) for p in probs], None, symbols)


class DeviceMeasurementResult(MeasurementResult):
    """Device-path result: outcome ``probs`` are exact; the dense state
    fields (``newState`` / ``unMeasuredDensity`` / ``basisDensity``)
    materialise on FIRST ACCESS by replaying the dense measurement
    engine (:func:`qbot_tpu_torch.ops.measurement.measure` — the reference
    math, measurement.py:107-165) on the gathered pre-measurement state.
    When the register is too large to gather (> %d qubits) the access
    raises a clear error naming the limitation instead of silently
    binding ``None``; touched from a program epilogue, the interpreter
    renders it with the 5-line source-context window.
    """ % _DENSE_REPLAY_LIMIT

    __slots__ = ("_dense_basis", "_dense_targets", "_dense_provider",
                 "_dense_collapse")

    def __init__(self, probs, basis_symbols, basis, targets, provider,
                 collapse: bool = True):
        super().__init__(None, probs, None, basis_symbols, None)
        self._dense_basis = basis
        self._dense_targets = targets
        self._dense_provider = provider
        self._dense_collapse = collapse
        # unset the state slots so attribute access falls to __getattr__
        del self.newState, self.unMeasuredDensity, self.basisDensity

    def __getattr__(self, item):
        if item in ("newState", "unMeasuredDensity", "basisDensity"):
            from qbot_tpu_torch.ops.measurement import measure

            rho = self._dense_provider()
            dense = measure(rho, self._dense_basis, self._dense_targets,
                            collapse=self._dense_collapse)
            self.newState = dense.newState
            self.unMeasuredDensity = dense.unMeasuredDensity
            self.basisDensity = dense.basisDensity
            return getattr(self, item)
        raise AttributeError(item)


def _too_large_provider(cur_n: int):
    def provider():
        raise RuntimeError(
            f"MeasurementResult state fields (newState/unMeasuredDensity/"
            f"basisDensity) are not materialised on the device path at "
            f"{cur_n} qubits (> {_DENSE_REPLAY_LIMIT}): the register "
            f"lives as a (possibly sharded) particle ensemble.  Read "
            f".probs, or run the dense interpreter for dense "
            f"post-measurement states")
    return provider


def _run_epilogue(lp: LoweredProgram) -> None:
    """Validate and drive the classical lines after the quantum program."""
    from qbot_tpu_torch.frontend.interpreter import peek_opcode, run_lines

    if lp.resume_line < 0 or not lp.has_epilogue:
        return
    for ln in range(lp.resume_line, len(lp.lines)):
        if peek_opcode(lp.lines[ln]) in _EPILOGUE_FORBIDDEN:
            raise _unsupported(lp.lines, ln,
                               "quantum operations after the final "
                               "measurement")
    run_lines(lp.namespace, lp.lines, start_line=lp.resume_line)


def _rotation_circuit(basis: Basis, targets, n: int,
                      inverse: bool = False) -> Circuit:
    """B† per block of ``targets`` (or its inverse) as a circuit.  Blocks
    are consecutive targets; the gate IR takes arbitrary target lists, so
    non-contiguous blocks (e.g. a bell measurement of qubits 0 and 5)
    lower to a cross-window contraction."""
    rot = np.stack(basis.kets).conj()
    if inverse:
        rot = rot.conj().T
    bq = basis.numQubits
    circ = Circuit(n)
    for i in range(0, len(targets), bq):
        circ.gate(rot, list(targets[i:i + bq]))
    return circ


def _basis_rotation_plans(basis: Basis, targets, n: int, window: int):
    """(rotate-into-basis plan, inverse plan) or (None, None) for the
    computation basis; rotation is B† per target block."""
    if _is_computational(basis):
        return None, None
    with profiling.named_scope("qbot.ensemble.compile"):
        return (compile_circuit(_rotation_circuit(basis, targets, n),
                                window=window),
                compile_circuit(_rotation_circuit(basis, targets, n, True),
                                window=window))


def _initial_planar(lp: LoweredProgram, device) -> torch.Tensor:
    """The normalised planar state ⊗``lp.initial_kets`` (2, 2^n) on
    ``device``: built on the program's first ensemble run there
    (:func:`product_state_planar`), then kept on ``lp`` and handed out
    again.  One state is kept, the newest device's, together with the
    identity of ``lp.initial_kets`` and of each of its arrays: rebinding
    the list or one of its arrays, or another device, builds it anew.
    Counts ``init_state_builds`` or ``init_state_reuses``.  The caller
    copies it: the kernels write an ensemble's states in place."""
    kets = lp.initial_kets
    key = [kets, *kets]
    kept = lp._init_planar
    if (kept is not None and kept[0] == device and len(kept[1]) == len(key)
            and all(a is b for a, b in zip(kept[1], key))):
        profiling.count("init_state_reuses")
        return kept[2]
    lp._init_planar = None                  # the old state freed first
    psi0 = product_state_planar(kets, device)
    lp._init_planar = (device, key, psi0)
    profiling.count("init_state_builds")
    return psi0


def _save_ensemble_checkpoint(mgr, event: int, ens, cur_n: int, prev: int,
                              results: dict, gen) -> None:
    """Snapshot the ensemble + event cursor (and the sampler's generator
    state) for elastic recovery."""
    arrays = {"log_w": ens.log_w, "psi": ens.psi}
    if gen is not None:
        arrays["key"] = gen.get_state()
    mgr.save(event, arrays, {
        "event": event, "cur_n": cur_n, "prev": prev,
        "lost_mass": float(ens.lost_mass),
        "results": {name: [float(p) for p in r.probs]
                    for name, r in results.items()},
    })


def warn_lost_mass(lost: float, prune_tol: float) -> None:
    """The warning of a run whose pruning dropped more than
    ``prune_tol`` of the probability mass."""
    if lost > prune_tol:
        import warnings
        warnings.warn(
            f"ensemble pruning dropped {lost:.3e} probability mass "
            f"(> prune_tol={prune_tol:g}); reported outcome probabilities "
            f"carry up to that much total-variation error — raise "
            f"max_particles or switch to sampling mode (sample > 0)",
            RuntimeWarning, stacklevel=3)


@profiling.spanned("qbot.ensemble")
def run_lowered_ensemble(lp: LoweredProgram, max_particles: int = 256,
                         window: int = 7, collapse_mode: str = "reference",
                         sample: int = 0, seed: int = 0,
                         checkpoint_dir: Optional[str] = None,
                         checkpoint_every: int = 1,
                         prune_tol: float = 1e-6, device="cuda"):
    """Execute a mid-measurement program on the device ensemble engine.

    Requires ``lower_program(text, mid_measure=True)``.  Each ``meas`` fans
    the particle ensemble over its outcomes (exact ProbVal semantics, capped
    at ``max_particles`` branches); ``peek`` reads the marginal without
    collapse.  Binds every MeasurementResult, runs the classical epilogue,
    and returns (results dict, final QuantumEnsemble on ``device``).

    ``sample > 0`` switches to the SMC regime: a fixed population of
    ``sample`` particles each SAMPLES one outcome per measurement (optimal
    Born proposal, :func:`~qbot_tpu_torch.inference.ensemble_exec.
    measure_sample`) instead of fanning out — memory stays constant however
    deep the measurement sequence.  ``seed`` seeds the sampler, a
    :class:`torch.Generator` on ``device`` (CLI ``--seed``); its draws are
    not the reference's.

    Exact fan-out mode tracks the probability mass dropped by the
    ``max_particles`` prune (``QuantumEnsemble.lost_mass``, an exact
    total-variation error bound on every reported distribution); if it
    exceeds ``prune_tol`` a ``RuntimeWarning`` is emitted.

    ``checkpoint_dir`` enables elastic recovery: the ensemble (log-weights,
    planar states, generator state) plus the event cursor and bound
    outcome distributions are snapshotted every ``checkpoint_every``
    measurement/discard events.  A re-invocation with the same directory
    resumes from the latest snapshot.
    """
    from qbot_tpu_torch.inference import ensemble_exec as ee

    device = torch.device(device)
    with profiling.named_scope("qbot.ensemble.init"):
        if lp.initial_density is not None:
            ens = ee.init_mixed_ensemble(lp.initial_density, device=device)
            if sample:
                reps = max(1, sample // ens.num_particles)
                ens = ee.QuantumEnsemble(
                    torch.repeat_interleave(ens.log_w, reps) - np.log(reps),
                    torch.repeat_interleave(ens.psi, reps, dim=0))
        else:
            # the product state is built on the device once per program;
            # every run starts from copies of it (B = 1: a clone)
            B = max(1, sample)
            psi0 = _initial_planar(lp, device)
            ens = ee.uniform_ensemble(psi0.clone() if B == 1 else psi0, B)
    gen = None
    if sample:
        gen = torch.Generator(device=device).manual_seed(seed)

    all_ops = list(lp.circuit.ops)
    cur_n = lp.n
    prev = 0
    results: dict[str, object] = {}

    mgr = None
    start_event = 0
    saved_probs: dict = {}
    if checkpoint_dir is not None:
        from qbot_tpu_torch.utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint_dir)
        if mgr.latest_step() is not None:
            arrays, meta = mgr.restore()
            ens = ee.QuantumEnsemble.from_numpy(
                arrays["log_w"], arrays["psi"],
                float(meta.get("lost_mass", 0.0)), device)
            if sample and "key" in arrays:
                gen.set_state(torch.from_numpy(arrays["key"]))
            cur_n = int(meta["cur_n"])
            prev = int(meta["prev"])
            start_event = int(meta["event"])
            saved_probs = meta.get("results", {})

    def run_segment(ens, ops, n):
        if not ops:
            return ens
        seg = Circuit(n)
        seg.ops = list(ops)
        seg.num_params = lp.circuit.num_params
        with profiling.named_scope("qbot.ensemble.compile"):
            plan = compile_circuit(seg, window=window)
        return ee.apply_plan_ensemble(ens, plan)

    def snapshot(ei):
        if mgr is not None and (ei + 1) % checkpoint_every == 0:
            _save_ensemble_checkpoint(mgr, ei + 1, ens, cur_n, prev,
                                      results, gen)

    for ei, spec in enumerate(lp.mid_measurements):
        if ei < start_event:
            # already executed before the snapshot: re-bind the recorded
            # outcome distributions, skip the device work
            if isinstance(spec, MeasSpec):
                results[spec.name] = _make_result(
                    spec.basis, sorted(spec.targets),
                    saved_probs[spec.name])
            continue
        ens = run_segment(ens, all_ops[prev:spec.at_op], cur_n)
        prev = spec.at_op
        if isinstance(spec, QSetSpec):
            # targeted qset: per-particle partial trace + tensor insert
            # (reference replaceArbitrary semantics; target order kept);
            # ProbVal target-set branches fan out (exact: pruned concat;
            # sampled: resampled back down)
            with profiling.named_scope("qbot.ensemble.collapse"):
                ens = _replace(ens, spec, cur_n, sample, gen,
                               max_particles)
            snapshot(ei)
            continue
        targets = sorted(spec.targets)
        if isinstance(spec, DiscSpec):
            with profiling.named_scope("qbot.ensemble.collapse"):
                ens = _discard(ens, spec, cur_n, targets, sample, gen,
                               max_particles)
            cur_n -= len(targets)
            snapshot(ei)
            continue
        rot, inv = _basis_rotation_plans(spec.basis, list(targets), cur_n,
                                         window)
        # lazy dense-field provider: the PRE-measurement mixture (gathered
        # on first .newState/.basisDensity access at small n)
        if cur_n <= _DENSE_REPLAY_LIMIT:
            provider = (lambda e=ens: ee.ensemble_mixture(e))
        else:
            provider = _too_large_provider(cur_n)
        ens_m = ee.apply_plan_ensemble(ens, rot) if rot else ens
        dist = None
        if spec.collapse:
            with profiling.named_scope("qbot.ensemble.collapse"):
                if sample:
                    ens_m, dist, _ = ee.measure_sample(gen, ens_m, cur_n,
                                                       targets)
                else:
                    ens_m, dist = ee.measure_fanout(ens_m, cur_n, targets,
                                                    max_particles,
                                                    mode=collapse_mode)
            ens = ee.apply_plan_ensemble(ens_m, inv) if inv else ens_m
        with profiling.named_scope("qbot.ensemble.readout"):
            if dist is None:
                dist = ee.peek_probs(ens_m, cur_n, targets)
            with profiling.sync():
                dist = dist.cpu().numpy()
            results[spec.name] = _make_result(spec.basis, targets, dist,
                                              provider=provider)
        snapshot(ei)

    ens = run_segment(ens, all_ops[prev:], cur_n)
    with profiling.named_scope("qbot.ensemble.epilogue"):
        warn_lost_mass(profiling.host_float(ens.lost_mass), prune_tol)
        for name, res in results.items():
            lp.namespace[name] = res
        _run_epilogue(lp)
    return results, ens


def _replace(ens, spec, n: int, sample: int, gen, max_particles: int):
    """A targeted ``qset`` of :func:`run_lowered_ensemble`: sampled, or
    fanned out and pruned; ProbVal target sets mixed."""
    from qbot_tpu_torch.inference import ensemble_exec as ee

    if spec.branches and len(spec.branches) > 1:
        if sample:
            return ee.concat_resampled(
                gen, [(p, ee.replace_sample(gen, ens, n, list(t),
                                            spec.new_states))
                      for p, t in spec.branches],
                ens.num_particles)
        return ee.concat_weighted(
            [(p, ee.replace_fanout(ens, n, list(t), spec.new_states,
                                   max_particles))
             for p, t in spec.branches], max_particles)
    if sample:
        return ee.replace_sample(gen, ens, n, list(spec.targets),
                                 spec.new_states)
    return ee.replace_fanout(ens, n, list(spec.targets), spec.new_states,
                             max_particles)


def _discard(ens, spec, n: int, targets, sample: int, gen,
             max_particles: int):
    """A ``disc`` of :func:`run_lowered_ensemble`: sampled, or fanned out
    and pruned; ProbVal target sets (all the same size by lowering)
    mixed."""
    from qbot_tpu_torch.inference import ensemble_exec as ee

    if spec.branches and len(spec.branches) > 1:
        if sample:
            return ee.concat_resampled(
                gen, [(p, ee.discard_sample(gen, ens, n, sorted(t)))
                      for p, t in spec.branches],
                ens.num_particles)
        return ee.concat_weighted(
            [(p, ee.discard_fanout(ens, n, sorted(t), max_particles))
             for p, t in spec.branches], max_particles)
    if sample:
        return ee.discard_sample(gen, ens, n, targets)
    return ee.discard_fanout(ens, n, targets, max_particles)


def _ket_to_unitary(ket: np.ndarray) -> np.ndarray:
    """Complete a unit ket to a unitary whose first column is exactly it."""
    d = ket.shape[0]
    ket = ket / np.linalg.norm(ket)
    A = np.eye(d, dtype=complex)
    A[:, 0] = ket
    # move the most-aligned basis column out of the way to keep A full rank
    pivot = int(np.argmax(np.abs(ket)))
    if pivot != 0:
        A[:, pivot] = np.eye(d)[:, 0]
    Q, R = np.linalg.qr(A)
    return Q * (R[0, 0] / abs(R[0, 0]))   # fix the first-column phase


def _factorize_ket(ket: np.ndarray, tol: float = 1e-9) -> list[np.ndarray]:
    """Greedy Schmidt factorization of a pure ket into tensor factors.

    Peels the smallest separable leading block repeatedly, so a product
    state that arrived as one merged 2^n ket (e.g. via ``tensorProd`` of
    densities) becomes a list of small kets — each preparable by a small
    local unitary instead of one n-qubit gate (which could never be
    localised on a sharded register).  Entangled blocks stay whole.
    """
    factors: list[np.ndarray] = []
    rest = np.asarray(ket, complex)
    n = int_log2(rest.shape[0])
    while n > 1:
        for a in range(1, n):
            M = rest.reshape(2**a, 2 ** (n - a))
            u, s, vh = np.linalg.svd(M, full_matrices=False)
            if s[1:].max(initial=0.0) < tol:       # rank-1: separable here
                factors.append(u[:, 0] * s[0])
                rest = vh[0]
                n -= a
                break
        else:
            break
    factors.append(rest)
    return factors


def _full_circuit(lp: LoweredProgram, window: int) -> "Circuit":
    """Prepend product-state prep and append basis rotation to the circuit.

    State prep: each tensor factor |ψᵢ⟩ becomes one unitary U with
    U|0…0⟩ = |ψᵢ⟩ on its qubit block.  Basis rotation: B† per target block
    so computation-basis probabilities read out the requested basis.
    """
    circ = Circuit(lp.n)
    q = 0
    for big in lp.initial_kets:
        for ket in _factorize_ket(big):
            k = int_log2(ket.shape[0])
            if not np.allclose(ket, np.eye(ket.shape[0])[:, 0]):
                circ.gate(_ket_to_unitary(np.asarray(ket, complex)),
                          list(range(q, q + k)))
            q += k
    circ.ops.extend(lp.circuit.ops)
    circ.num_params = lp.circuit.num_params
    basis = lp.measure_basis
    if basis is not None and not _is_computational(basis):
        circ.ops.extend(_rotation_circuit(basis, lp.measure_targets,
                                          lp.n).ops)
    return circ


def finish_lowered(lp: LoweredProgram, probs,
                   provider=None) -> Optional[object]:
    """Bind the measurement result and run the classical epilogue.

    Called by the run_lowered* executors after device execution: builds a
    :class:`MeasurementResult` from the outcome distribution (same readout
    format as the dense interpreter), binds it under the measured name, and
    drives the interpreter over the lines after the measurement (``cout``,
    ``pydo``, classical control flow).  Quantum ops there — or jumps back
    into the circuit region — are outside the unitary fragment and raise.

    ``provider`` (no-arg callable returning the dense pre-measurement ρ)
    makes the bound result a :class:`DeviceMeasurementResult` whose state
    fields materialise lazily (or raise a clear limitation error).
    """
    if lp.measure_basis is None or probs is None:
        return None
    result = _make_result(lp.measure_basis, list(lp.measure_targets),
                          [float(p) for p in probs], provider=provider)
    lp.namespace[lp.measure_name] = result
    _run_epilogue(lp)
    return result



def _is_computational(basis) -> bool:
    return basis.numQubits == 1 and all(
        np.allclose(k, e) for k, e in zip(basis.kets,
                                          np.eye(2, dtype=complex)))


def run_lowered(lp: LoweredProgram, window: Union[int, str] = 7,
                use_planar: bool = True, device="cuda",
                plan: Optional[Plan] = None):
    """Execute a lowered program on ``device``.

    ``use_planar`` runs the planar executor (the kernels on a CUDA device);
    ``use_planar=False`` the complex ``complex64`` simulator
    (:mod:`qbot_tpu_torch.tpu.simulator`, plain PyTorch), from the product
    of the initial kets, as ``qbot_tpu``'s ``run_lowered`` does
    (``qbot_tpu/frontend/lowering.py:1702-1767``).  ``plan`` is
    ``compile_circuit(lp.circuit, window)`` (paired) when the caller has
    compiled it already; it is compiled here when None.  ``window`` is a
    width or ``"auto"`` (:func:`~qbot_tpu_torch.tpu.compiler.compile_circuit`),
    and the post-rotation plan of a general product basis compiles with it.

    Returns (outcome probabilities as numpy, or None without a final
    measurement; final state tensor on ``device``: planar ``(2, 2^n)``
    float32, or a flat complex vector with ``use_planar=False``).
    """
    device = torch.device(device)
    if plan is None:
        plan = compile_circuit(lp.circuit, window=window)
    if use_planar:
        apply = apply_plan_planar
        psi = apply(product_state_planar(lp.initial_kets, device), plan)

        def probs_of(state, targets):
            return planar_probs(state, targets, lp.n)
    else:
        apply = simulator.apply_plan
        psi0 = np.array([1.0 + 0j])
        for ket in lp.initial_kets:
            psi0 = np.kron(psi0, ket)
        psi = apply(torch.as_tensor(psi0, device=device).to(
            simulator.DTYPE), plan)

        def probs_of(state, targets):
            return simulator.computation_probs(state, targets, lp.n)
    if lp.measure_basis is None:
        return None, psi

    basis = lp.measure_basis
    targets = lp.measure_targets

    def provider(psi=psi, n=lp.n):
        if n > _DENSE_REPLAY_LIMIT:
            _too_large_provider(n)()
        host = psi.cpu().numpy()
        ket = (host[0] + 1j * host[1]) if use_planar else host
        return np.outer(ket, np.conj(ket))

    if _is_computational(basis):
        probs = probs_of(psi, targets).cpu().numpy()
        finish_lowered(lp, probs, provider=provider)
        return probs, psi

    # general product basis: rotate the measured qubits into the basis
    # frame (B† per block), then read computational probabilities
    psi_rot = apply(psi, compile_circuit(
        _rotation_circuit(basis, targets, lp.n), window=window))
    probs = probs_of(psi_rot, targets).cpu().numpy()
    finish_lowered(lp, probs, provider=provider)
    return probs, psi


def run_lowered_sharded(lp: LoweredProgram, k: Optional[int] = None,
                        mesh=None, window: int = 7, device="cuda"):
    """Execute a lowered program on a qubit-sharded register, as this rank
    of ``mesh`` (``qbot_tpu/frontend/lowering.py:1646-1700``).

    SPMD: every rank of the :class:`~qbot_tpu_torch.tpu.sharding.QubitMesh`
    calls it with the same program.  The full program (state prep, gates,
    basis rotation) compiles through
    :func:`~qbot_tpu_torch.tpu.sharded.compile_sharded` and runs on the
    rank's shard with ``all_to_all_single`` qubit reshards; the outcome
    probabilities assemble with one ``all_reduce``, on every rank.  Rank 0
    binds the result and runs the classical epilogue (a program of at most
    12 qubits gathers its state there first, for the result's dense
    fields).  ``k`` defaults to the mesh's; without ``mesh`` the process
    joins the group ``torchrun`` started, its ranks on ``device``.

    Returns (outcome probabilities as numpy or None, this rank's shard,
    the sharded plan).
    """
    from qbot_tpu_torch.tpu.sharded import (
        compile_sharded,
        gather_planar,
        make_sharded_planar_runner,
        sharded_probs_fn,
        sharded_zero_state,
        unpermute_planar,
    )

    if mesh is None:
        from qbot_tpu_torch.tpu.sharding import join_mesh

        mesh = join_mesh(device)
    if k is None:
        k = mesh.k
    splan = compile_sharded(_full_circuit(lp, window), k, window=window)
    run = make_sharded_planar_runner(splan, mesh)
    psi = run(sharded_zero_state(lp.n, mesh))
    if lp.measure_basis is None:
        return None, psi, splan

    dense = None
    if lp.n <= _DENSE_REPLAY_LIMIT:
        full = gather_planar(psi, mesh)
        if full is not None:
            dense = unpermute_planar(full, splan.final_perm).cpu().numpy()

    def provider(n=lp.n):
        if n > _DENSE_REPLAY_LIMIT:
            _too_large_provider(n)()
        ket = dense[0] + 1j * dense[1]
        return np.outer(ket, np.conj(ket))

    probs = sharded_probs_fn(splan, mesh,
                             targets=lp.measure_targets)(psi).cpu().numpy()
    if mesh.rank == 0:
        finish_lowered(lp, probs, provider=provider)
    return probs, psi, splan


def _reorder_outcome_bits(dist: np.ndarray, phys_logicals, logical_sorted):
    """Permute an outcome distribution from physical-target bit order to
    sorted-logical bit order (the interpreter's readout convention).

    ``phys_logicals``: the logical qubit held at each physical target
    position, in the physical (ascending) order the sharded outcome split
    used; ``logical_sorted``: the same qubits sorted logically.
    """
    if list(phys_logicals) == list(logical_sorted):
        return dist
    t = len(phys_logicals)
    pos_in_logical = {q: j for j, q in enumerate(logical_sorted)}
    out = np.empty_like(dist)
    for idx in range(dist.shape[0]):
        # physical bit i (MSB-first) holds the outcome of phys_logicals[i],
        # which sits at logical bit pos_in_logical[phys_logicals[i]]
        pidx = 0
        for i, q in enumerate(phys_logicals):
            bit = (idx >> (t - 1 - pos_in_logical[q])) & 1
            pidx |= bit << (t - 1 - i)
        out[idx] = dist[pidx]
    return out


def _positions(perm) -> list:
    """pos[logical qubit] = its physical position under ``perm``."""
    pos = [0] * len(perm)
    for p, q in enumerate(perm):
        pos[q] = p
    return pos


class _MeshCheckpoints:
    """Snapshots of the mesh runner: every rank writes its block (and its
    generators' states) to ``shard_<rank>.npz`` of the step's directory,
    then, after a barrier, rank 0 writes the step's metadata through the
    port's npz :class:`~qbot_tpu_torch.utils.checkpoint.CheckpointManager`:
    a step counts once its metadata exists."""

    def __init__(self, root: str, emesh):
        from qbot_tpu_torch.utils.checkpoint import CheckpointManager

        self.mgr, self.emesh = CheckpointManager(root), emesh

    def _shard(self, step: int) -> str:
        return os.path.join(self.mgr._step_dir(step),
                            f"shard_{self.emesh.rank:05d}.npz")

    def latest(self) -> Optional[int]:
        done = [s for s in self.mgr.all_steps() if os.path.exists(
            os.path.join(self.mgr._step_dir(s), "meta.json"))]
        return done[-1] if done else None

    def save(self, step: int, ens, gens, meta: dict) -> None:
        import torch.distributed as dist

        os.makedirs(self.mgr._step_dir(step), exist_ok=True)
        arrays = {"log_w": ens.log_w.cpu().numpy(),
                  "psi": ens.psi.cpu().numpy()}
        for name, gen in gens.items():
            arrays[name] = gen.get_state().numpy()
        np.savez(self._shard(step), **arrays)
        dist.barrier()
        if self.emesh.rank == 0:
            self.mgr.save(step, {}, {**meta, "P": self.emesh.P,
                                     "K": self.emesh.K})
        dist.barrier()

    def restore(self, step: int, gens):
        """(this rank's log_w, psi on its device, metadata)."""
        meta = self.mgr.restore(step)[1]
        if (meta["P"], meta["K"]) != (self.emesh.P, self.emesh.K):
            raise ValueError(f"the snapshot is of a {meta['P']}x{meta['K']} "
                             f"mesh, this run's is {self.emesh.P}x"
                             f"{self.emesh.K}")
        with np.load(self._shard(step)) as z:
            for name, gen in gens.items():
                gen.set_state(torch.from_numpy(z[name]))
            dev = self.emesh.device
            return (torch.from_numpy(z["log_w"]).to(dev),
                    torch.from_numpy(z["psi"]).to(dev), meta)


_MESH_PHASES = ("init", "segment", "reshard", "rotate", "collapse",
                "exchange", "fetch")


def _phase_walls(stats: dict, before: dict) -> None:
    """Add to ``stats["phase_walls"]`` each phase's host seconds in the
    spans ``qbot.ensemble.<phase>`` closed since ``before``
    (:func:`~qbot_tpu_torch.utils.profiling.span_totals`); nothing when
    spans were off."""
    after = profiling.span_totals()
    for name in _MESH_PHASES:
        now = after.get(f"qbot.ensemble.{name}")
        was = before.get(f"qbot.ensemble.{name}",
                         {"total_s": 0.0, "calls": 0})
        if now is not None and now["calls"] > was["calls"]:
            walls = stats.setdefault("phase_walls", {})
            walls[name] = (walls.get(name, 0.0) + now["total_s"]
                           - was["total_s"])


def _solo_mesh(device):
    """A 1 x 1 ensemble mesh in this process: a one-rank group on a free
    localhost port (``nccl`` on a card, ``gloo`` on the CPU)."""
    import torch.distributed as dist

    from qbot_tpu_torch.tpu.sharding import (
        _free_port,
        default_backend,
        ensemble_mesh,
        rank_device,
    )

    dev = rank_device(0, device)
    backend = default_backend(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=dev if backend == "nccl" else None)
    return ensemble_mesh((1, 1), dev)


def run_lowered_sharded_ensemble(lp: LoweredProgram, mesh=None,
                                 k: Optional[int] = None,
                                 particle_shards: int = 1,
                                 max_particles: int = 256,
                                 window: int = 7,
                                 collapse_mode: str = "reference",
                                 sample: int = 0, seed: int = 0,
                                 stats: Optional[dict] = None,
                                 checkpoint_dir: Optional[str] = None,
                                 checkpoint_every: int = 1,
                                 island_ess_threshold: float = 0.5,
                                 device="cuda"):
    """Mid-circuit measurement and ``disc`` on a (particles × qubits) mesh,
    as this rank of it (``qbot_tpu/frontend/lowering.py:979-1643``).

    SPMD: every rank of the :class:`~qbot_tpu_torch.tpu.sharding.
    EnsembleMesh` calls it with the same program.  The particle ensemble of
    :func:`run_lowered_ensemble` is split over the mesh's particle rows and
    each particle's state over its row's qubit shards
    (:mod:`qbot_tpu_torch.tpu.sharded_ensemble`), so ``meas``/``disc``
    anywhere in a program run at register sizes that need sharding, the
    register shrinking at ``disc``.  Requires ``lower_program(text,
    mid_measure=True)``.  Collapse events localise their targets with
    reshards, split outcomes shard-locally (Born probabilities summed over
    the qubit axis) and fan out within each row; ``sample > 0`` switches to
    the SMC regime (island resampling, constant memory), with
    :func:`~qbot_tpu_torch.tpu.sharded_ensemble.maybe_exchange_islands`
    after every collapse (effective island count below
    ``island_ess_threshold``·P: a whole-island resample).  Each row draws
    from its own generator seeded from (``seed``, p), so sampled runs do
    not repeat the reference's; a P = 1 mesh draws as
    :func:`run_lowered_ensemble` draws.

    ``mesh`` None joins the P × 2^k mesh (``particle_shards`` × 2^``k``)
    of the ranks ``torchrun`` started, or makes a 1 x 1 mesh in this
    process (a one-rank group, removed again at the end); a larger mesh
    without ``torchrun`` starts from
    :func:`~qbot_tpu_torch.tpu.sharding.launch`.  ``device`` is the ranks'
    device when the mesh is made here.

    ``checkpoint_dir``: snapshots every ``checkpoint_every`` collapse
    events, one shard file a rank (its block and generators) and rank 0's
    metadata (event cursor, qubit permutation, register width, bound
    outcome distributions); a re-run with the same directory on the same
    mesh shape resumes from the latest snapshot.

    ``stats`` (a dict) accumulates ``collapse_events``, ``num_reshards``,
    ``comm_bytes`` and ``hbm_bytes`` (per particle, times the particles
    that ran the plan), ``num_collectives`` (counted where the ensemble
    executors issue them), and ``phase_walls`` (host seconds per phase:
    init, segment, reshard, rotate, collapse, exchange, fetch, the spans
    ``qbot.ensemble.<phase>``; while spans are on only, inside
    :func:`qbot_tpu_torch.utils.profiling.tracing` or a profiler).  The
    dense state fields of a result at most 12 qubits wide are gathered
    when it is measured (a collective, on every rank).

    Returns (results dict, this rank's final ShardedEnsemble, final perm,
    the mesh).
    """
    import torch.distributed as dist

    from qbot_tpu_torch.tpu import sharded_ensemble as se
    from qbot_tpu_torch.tpu.planar import to_planar
    from qbot_tpu_torch.tpu.sharded import (
        ShardedPlan,
        compile_sharded,
        plan_reshards_to_localize,
    )

    solo = False
    if mesh is None:
        shape = (particle_shards, 2 ** (k or 0))
        if "WORLD_SIZE" in os.environ:
            from qbot_tpu_torch.tpu.sharding import join_mesh

            mesh = join_mesh(device, shape=shape)
        elif shape == (1, 1) and not dist.is_initialized():
            mesh, solo = _solo_mesh(device), True
        else:
            raise ValueError(
                f"a {shape[0]}x{shape[1]} mesh runs on its ranks: start "
                f"them with qbot_tpu_torch.tpu.sharding.launch or torchrun "
                f"and pass each its EnsembleMesh")
    emesh = mesh
    k = emesh.k
    before = profiling.span_totals()

    def phase(name: str):
        return profiling.named_scope(f"qbot.ensemble.{name}")

    try:
        with phase("init"):
            if lp.initial_density is not None:
                # mixed prep: the host eigensolve of a small density, the
                # SMC copies made on the host rows before padding
                vals, vecs = np.linalg.eigh(np.asarray(lp.initial_density,
                                                       complex))
                keep = vals > 1e-12
                vals, vecs = vals[keep], vecs[:, keep]
                psi0 = np.stack([to_planar(vecs[:, i])
                                 for i in range(vals.shape[0])])
                lw = np.log(vals / vals.sum())
                if sample:
                    reps = max(1, sample // psi0.shape[0])
                    psi0 = np.repeat(psi0, reps, axis=0)
                    lw = np.repeat(lw, reps) - np.log(reps)
                ens = se.init_sharded_ensemble(psi0, emesh, log_w=lw)
            else:
                # the product state and its SMC copies, built on the device
                ens = se.init_product_sharded_ensemble(
                    lp.initial_kets, emesh, B=max(1, sample))
        gens = {}
        if sample:
            gens = {"row_gen": se.row_generator(seed, emesh),
                    "mesh_gen": se.mesh_generator(seed, emesh)}

        all_ops = list(lp.circuit.ops)
        cur_n = lp.n
        perm = list(range(cur_n))
        prev = 0
        results: dict[str, object] = {}
        if stats is not None:
            for key in ("comm_bytes", "hbm_bytes", "num_reshards",
                        "num_collectives", "collapse_events"):
                stats.setdefault(key, 0)

        ckpt = None
        start_event = 0
        saved_probs: dict = {}
        if checkpoint_dir is not None:
            ckpt = _MeshCheckpoints(checkpoint_dir, emesh)
            step = ckpt.latest()
            if step is not None:
                log_w, psi, meta = ckpt.restore(step, gens)
                ens = se.ShardedEnsemble(log_w, psi,
                                         float(meta.get("lost_mass", 0.0)),
                                         emesh.P)
                cur_n = int(meta["cur_n"])
                perm = [int(q) for q in meta["perm"]]
                prev = int(meta["prev"])
                start_event = int(meta["event"])
                saved_probs = meta.get("results", {})

        def snapshot(event: int, ens) -> None:
            if ckpt is None or event % checkpoint_every != 0:
                return
            ckpt.save(event, ens, gens, {
                "event": event, "cur_n": cur_n, "prev": prev,
                "perm": [int(q) for q in perm],
                "lost_mass": float(ens.lost_mass),
                "results": {name: [float(p) for p in r.probs]
                            for name, r in results.items()}})

        def acc(splan, B) -> None:
            """Exact comm/HBM counts (B particles ran the plan)."""
            if stats is None:
                return
            stats["comm_bytes"] += B * splan.comm_bytes()
            stats["hbm_bytes"] += B * splan.hbm_bytes()
            stats["num_reshards"] += splan.num_reshards

        def run_plan(ens, splan, name: str):
            if splan is None or not splan.items:
                return ens
            acc(splan, ens.num_particles)
            with phase(name):
                return se.apply_sharded_plan_ensemble(ens, splan, emesh)

        def run_segment(ens, ops, n, perm):
            if not ops:
                return ens, perm
            seg = Circuit(n)
            seg.ops = list(ops)
            seg.num_params = lp.circuit.num_params
            splan = compile_sharded(seg, k, window=window, initial_perm=perm)
            return run_plan(ens, splan, "segment"), list(splan.final_perm)

        def run_items(ens, items, n, perm, name: str = "reshard"):
            if not items:
                return ens
            return run_plan(ens, ShardedPlan(
                n=n, k=k, items=list(items), final_perm=perm,
                num_params=lp.circuit.num_params), name)

        def collapse(fn, *args, **kw):
            with phase("collapse"):
                return fn(*args, **kw)

        def exchange(ens):
            with phase("exchange"):
                ens, _ = se.maybe_exchange_islands(
                    gens["mesh_gen"], ens, emesh,
                    threshold=island_ess_threshold, stats=stats)
            return ens

        row_gen = gens.get("row_gen")
        for ei, spec in enumerate(lp.mid_measurements):
            if ei < start_event:
                # executed before the snapshot: re-bind recorded outcomes
                if isinstance(spec, MeasSpec):
                    results[spec.name] = _make_result(
                        spec.basis, sorted(spec.targets),
                        saved_probs[spec.name])
                continue
            ens, perm = run_segment(ens, all_ops[prev:spec.at_op], cur_n,
                                    perm)
            prev = spec.at_op
            if stats is not None:
                stats["collapse_events"] += 1

            if isinstance(spec, QSetSpec):
                # targeted qset: localise the targets, then the partial
                # trace and tensor insertion are shard-local (the
                # positions are re-populated in place: the perm stays);
                # ProbVal target sets fan out and are pruned (exact) or
                # resampled back down (sampled)
                many = spec.branches and len(spec.branches) > 1
                union = sorted({q for _, t in spec.branches for q in t}
                               if many else set(spec.targets))
                items, perm = plan_reshards_to_localize(perm, cur_n, k,
                                                        union)
                ens = run_items(ens, items, cur_n, perm)
                pos = _positions(perm)
                with phase("collapse"):
                    if many:
                        if sample:
                            B_keep = ens.num_particles
                            parts = [(pb, se.replace_sample_sharded(
                                row_gen, ens, cur_n, [pos[q] - k for q in t],
                                spec.new_states, emesh, stats=stats))
                                for pb, t in spec.branches]
                            ens = se.resample_down_sharded(
                                row_gen, se.concat_sharded(parts, emesh),
                                B_keep, emesh, stats=stats)
                        else:
                            parts = [(pb, se.replace_fanout_sharded(
                                ens, cur_n, [pos[q] - k for q in t],
                                spec.new_states, emesh, max_particles,
                                stats=stats))
                                for pb, t in spec.branches]
                            ens = se.prune_sharded(
                                se.concat_sharded(parts, emesh), max_particles,
                                emesh, stats=stats)
                    elif sample:
                        ens = se.replace_sample_sharded(
                            row_gen, ens, cur_n,
                            [pos[q] - k for q in spec.targets],
                            spec.new_states, emesh, stats=stats)
                    else:
                        ens = se.replace_fanout_sharded(
                            ens, cur_n, [pos[q] - k for q in spec.targets],
                            spec.new_states, emesh, max_particles, stats=stats)
                snapshot(ei + 1, ens)
                continue

            targets = sorted(spec.targets)
            if isinstance(spec, DiscSpec):
                many = spec.branches and len(spec.branches) > 1
                union = (sorted({q for _, t in spec.branches for q in t})
                         if many else targets)
                items, perm = plan_reshards_to_localize(perm, cur_n, k,
                                                        union)
                ens = run_items(ens, items, cur_n, perm)
                pos = _positions(perm)
                if many:
                    # ProbVal target sets: per-branch discards, each
                    # brought to the identity layout, mixed on the
                    # particle axis (exact: pruned; sampled: resampled)
                    from qbot_tpu_torch.tpu.sharded import (
                        plan_perm_to_identity,
                    )

                    new_n = cur_n - len(spec.branches[0][1])
                    B_keep = ens.num_particles
                    parts = []
                    for p, tset in spec.branches:
                        local = sorted(pos[q] - k for q in tset)
                        if sample:
                            e2 = se.discard_sample_sharded(
                                row_gen, ens, cur_n, local, emesh,
                                stats=stats)
                        else:
                            e2 = se.discard_fanout_sharded(
                                ens, cur_n, local, emesh, max_particles,
                                stats=stats)
                        removed = {pos[q] for q in tset}
                        bperm = [q - sum(1 for r in tset if r < q)
                                 for pp, q in enumerate(perm)
                                 if pp not in removed]
                        fix, idp = plan_perm_to_identity(bperm, new_n, k)
                        parts.append((p, run_items(e2, fix, new_n, idp)))
                    if sample:
                        ens = collapse(se.resample_down_sharded, row_gen,
                                       se.concat_sharded(parts, emesh),
                                       B_keep, emesh, stats=stats)
                        ens = exchange(ens)
                    else:
                        ens = collapse(se.prune_sharded,
                                       se.concat_sharded(parts, emesh),
                                       max_particles, emesh, stats=stats)
                    perm = list(range(new_n))
                    cur_n = new_n
                    snapshot(ei + 1, ens)
                    continue
                local = sorted(pos[q] - k for q in targets)
                if sample:
                    ens = collapse(se.discard_sample_sharded, row_gen, ens,
                                   cur_n, local, emesh, stats=stats)
                    ens = exchange(ens)
                else:
                    ens = collapse(se.discard_fanout_sharded, ens, cur_n,
                                   local, emesh, max_particles, stats=stats)
                removed = {pos[q] for q in targets}
                perm = [q - sum(1 for r in targets if r < q)
                        for p, q in enumerate(perm) if p not in removed]
                cur_n -= len(targets)
                snapshot(ei + 1, ens)
                continue

            # meas / peek
            rot_needed = not _is_computational(spec.basis)
            if cur_n <= _DENSE_REPLAY_LIMIT:
                # the pre-measurement mixture, gathered now on every rank
                # (a collective cannot wait for one rank's lazy read)
                rho = se.sharded_ensemble_mixture(ens, emesh, perm)
                provider = (lambda rho=rho: rho)
            else:
                provider = _too_large_provider(cur_n)
            if rot_needed:
                splan = compile_sharded(
                    _rotation_circuit(spec.basis, targets, cur_n), k,
                    window=window, initial_perm=perm)
                ens_m = run_plan(ens, splan, "rotate")
                perm_m = list(splan.final_perm)
            else:
                ens_m, perm_m = ens, list(perm)

            def target_layout(perm_m):
                pos = _positions(perm_m)
                shard_pos = sorted(pos[q] for q in targets if pos[q] < k)
                local = sorted(pos[q] - k for q in targets if pos[q] >= k)
                # outcome bit order of the split: sharded targets
                # (ascending position) first, then local (ascending)
                phys = ([perm_m[p] for p in shard_pos]
                        + [perm_m[a + k] for a in local])
                return shard_pos, local, phys

            shard_pos, local, phys_logicals = target_layout(perm_m)
            # reference-mode collapse relocates outcome blocks, which needs
            # local targets, except when measuring every qubit, where the
            # two modes coincide; projective, sampled and peek read
            # sharded targets off the rank
            mode_here = collapse_mode
            if spec.collapse and not sample and mode_here == "reference":
                if len(targets) == cur_n:
                    mode_here = "projective"
                elif shard_pos:
                    items, perm_m = plan_reshards_to_localize(
                        perm_m, cur_n, k, targets)
                    ens_m = run_items(ens_m, items, cur_n, perm_m)
                    shard_pos, local, phys_logicals = target_layout(perm_m)

            if spec.collapse:
                if sample:
                    ens_m, dist_ = collapse(
                        se.measure_sample_sharded, row_gen, ens_m, cur_n,
                        local, emesh, shard_positions=shard_pos,
                        stats=stats)
                    ens_m = exchange(ens_m)
                else:
                    ens_m, dist_ = collapse(
                        se.measure_fanout_sharded, ens_m, cur_n, local,
                        emesh, max_particles, mode=mode_here,
                        shard_positions=shard_pos, stats=stats)
                if rot_needed:
                    splan = compile_sharded(
                        _rotation_circuit(spec.basis, targets, cur_n,
                                          inverse=True), k,
                        window=window, initial_perm=perm_m)
                    ens_m = run_plan(ens_m, splan, "rotate")
                    perm_m = list(splan.final_perm)
                ens, perm = ens_m, perm_m
            else:
                dist_ = collapse(se.peek_probs_sharded, ens_m, cur_n, local,
                                 emesh, shard_positions=shard_pos,
                                 stats=stats)
            with phase("fetch"), profiling.sync():
                dist_ = dist_.cpu().numpy()
            dist_ = _reorder_outcome_bits(dist_, phys_logicals, targets)
            results[spec.name] = _make_result(spec.basis, targets, dist_,
                                              provider=provider)
            snapshot(ei + 1, ens)

        ens, perm = run_segment(ens, all_ops[prev:], cur_n, perm)
        with phase("fetch"):
            lost = profiling.host_float(ens.lost_mass)
        warn_lost_mass(lost, 1e-6)
        for name, res in results.items():
            lp.namespace[name] = res
        _run_epilogue(lp)
        if stats is not None:
            _phase_walls(stats, before)
        return results, ens, perm, emesh
    finally:
        if solo:
            dist.destroy_process_group()
