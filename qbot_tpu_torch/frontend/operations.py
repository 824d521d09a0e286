"""The DSL operation set.

Capability parity with the reference's ``qbot/operators.py``
(qbot/operators.py:143-506): the 13 live operations
``cdef qdef qset gate disc swap meas peek jump cjmp halt retr pydo cout``
(plus ``note``/``mark`` handled by the runtime), with identical operand
arities, evaluation order, ProbVal fan-out behaviour and namespace
bookkeeping (``__is_q_*`` / ``__updated_*`` shadow keys).

Engine difference: operations act on the register through the axis
contraction engine (:mod:`qbot_tpu_torch.ops.core`) — a ``gate`` line applies a
k-qubit matrix directly to the target qubit axes instead of building a
2^n×2^n full-space operator (the reference's `_gate` path,
operators.py:255-271).

Reference defects fixed (SURVEY.md §2.3): bare kets auto-convert to density
matrices in ``qset``/``qdef`` (the reference dropped the conversion result,
operators.py:70-72), and ``meas`` with ProbVal targets works.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

import qbot_tpu_torch.errors as err
from qbot_tpu_torch import backend
from qbot_tpu_torch.basis import Basis
from qbot_tpu_torch.frontend.evaluation import evaluate_expr
from qbot_tpu_torch.ops import core, gates
from qbot_tpu_torch.ops.measurement import (
    MeasurementIndexError,
    MeasurementResult,
    measure,
)
from qbot_tpu_torch.probval import ProbVal, lift

__all__ = ["OPERATIONS", "OpResult", "set_val", "hilbert_qubits"]


class OpResult:
    """Control-flow outcome of an operation (jump target and/or halt)."""

    __slots__ = ("jump_line", "halt")

    def __init__(self, jump_line: Optional[int] = None, halt: bool = False):
        self.jump_line = jump_line
        self.halt = halt


def hilbert_qubits(state) -> int:
    return core.num_qubits(state)


def _var_name(lines, line_num, token: str) -> str:
    if not token.isidentifier():
        raise err.invalid_variable_name(lines, line_num, token)
    return token


def _mark_line(ns, lines, line_num, token: str) -> int:
    marks = ns["__marks"]
    if token.isidentifier() and token in marks:
        return marks[token]
    res = evaluate_expr(lines, line_num, token, ns)
    if isinstance(res, str):
        try:
            return marks[res]
        except KeyError:
            raise err.unknown_mark_name(lines, line_num, token) from None
    got = res.type_string() if isinstance(res, ProbVal) else type(res).__name__
    raise err.type_error(lines, line_num, ["str"], got)


def _check_probval_type(lines, line_num, val, t) -> None:
    if isinstance(val, t):
        return
    if isinstance(val, ProbVal):
        if not isinstance(val.instance(), t):
            raise err.type_error(lines, line_num,
                                 [t.__name__, f"ProbVal<{t.__name__}>"],
                                 val.type_string())
        return
    raise err.type_error(lines, line_num,
                         [t.__name__, f"ProbVal<{t.__name__}>"],
                         type(val).__name__)


def _to_density(lines, line_num, val):
    """Coerce an operand to a density matrix (kets and ProbVals folded)."""
    if isinstance(val, ProbVal):
        try:
            val = val.to_density_matrix()
        except Exception:
            raise err.type_error(lines, line_num,
                                 ["np.ndarray", "ProbVal<np.ndarray>"],
                                 val.type_string()) from None
    if not backend.is_array(val):
        raise err.type_error(lines, line_num,
                             ["np.ndarray", "ProbVal<np.ndarray>"],
                             type(val).__name__)
    if val.ndim == 1 and val.size:
        val = core.ket_to_density(val, xp=backend.xp())
    dt = backend.dtype_override()
    if dt is not None and val.size and val.dtype != dt:
        val = val.astype(dt)
    return val


def set_val(ns, lines, line_num, key, value, quantum=True):
    """Bind a namespace variable, maintaining the quantum-ness shadow keys."""
    if quantum:
        ns[key] = _to_density(lines, line_num, value)
    else:
        ns[key] = value
    ns[f"__is_q_{key}"] = quantum
    ns[f"__updated_{key}"] = True


_INT_TYPES = (int, np.integer)


def _container_type_error(lines, line_num, val, required):
    names = [f"{c}<{required}>" for c in ("list", "set", "tuple")]
    names.append(str(required))
    expected = [f"ProbVal<{n}>" for n in names]
    raise err.type_error(lines, line_num, expected, type(val).__name__)


def _ensure_container(lines, line_num, val, required=_INT_TYPES):
    """Wrap a scalar in a list; typecheck containers; normalise ProbVal branches."""
    if isinstance(val, (list, set, tuple)):
        for item in val:
            if not isinstance(item, required):
                _container_type_error(lines, line_num, val, "int")
        return val
    if isinstance(val, ProbVal):
        # normalise into a COPY: wrapping scalar branches in-place would
        # silently reshape a user ProbVal reused across several ops
        branches = []
        for branch in val.values:
            if isinstance(branch, (list, set, tuple)):
                for item in branch:
                    if not isinstance(item, required):
                        _container_type_error(lines, line_num, val, "int")
                branches.append(branch)
                continue
            if not isinstance(branch, required):
                _container_type_error(lines, line_num, val, "int")
            branches.append([branch])
        return ProbVal.raw(val.probs, branches)
    if not isinstance(val, required):
        _container_type_error(lines, line_num, val, "int")
    return [val]


def _check_targets_in_range(lines, line_num, targets, n, kind="target"):
    for t in targets:
        if t < 0 or t > n - 1:
            raise err.index_error(lines, line_num, kind, t, n - 1)


# ---------------------------------------------------------------------------
# defines
# ---------------------------------------------------------------------------

def op_cdef(ns, lines, line_num, tokens):
    name = _var_name(lines, line_num, tokens[1])
    val = evaluate_expr(lines, line_num, tokens[2], ns)
    set_val(ns, lines, line_num, name, val, quantum=False)


def op_qdef(ns, lines, line_num, tokens):
    name = _var_name(lines, line_num, tokens[1])
    val = evaluate_expr(lines, line_num, tokens[2], ns)
    set_val(ns, lines, line_num, name, val, quantum=True)


# ---------------------------------------------------------------------------
# state manipulation
# ---------------------------------------------------------------------------

def op_qset(ns, lines, line_num, tokens):
    n = hilbert_qubits(ns["state"])
    val = _to_density(lines, line_num, evaluate_expr(lines, line_num, tokens[1], ns))

    if len(tokens) == 2:
        set_val(ns, lines, line_num, "state", val)
        return

    targets = _ensure_container(
        lines, line_num, evaluate_expr(lines, line_num, tokens[2], ns))

    def _replace(tgts):
        _check_targets_in_range(lines, line_num, tgts, n)
        try:
            return core.replace_qubits(ns["state"], val, list(tgts),
                                       xp=backend.xp())
        except ValueError as e:
            raise err.python_error(lines, line_num, e) from e

    if isinstance(targets, ProbVal):
        mixed = lift(_replace, targets)
        if isinstance(mixed, ProbVal):
            mixed = mixed.to_density_matrix()
        set_val(ns, lines, line_num, "state", mixed)
    else:
        set_val(ns, lines, line_num, "state", _replace(targets))


def op_disc(ns, lines, line_num, tokens):
    n = hilbert_qubits(ns["state"])
    targets = _ensure_container(
        lines, line_num, evaluate_expr(lines, line_num, tokens[1], ns))

    def _discard(tgts):
        _check_targets_in_range(lines, line_num, tgts, n)
        keep = [q for q in range(n) if q not in set(tgts)]
        return core.partial_trace_keep(ns["state"], keep, xp=backend.xp())

    if isinstance(targets, ProbVal):
        val = lift(_discard, targets)
    else:
        val = _discard(targets)
    set_val(ns, lines, line_num, "state", _to_density(lines, line_num, val))


def op_gate(ns, lines, line_num, tokens):
    n = hilbert_qubits(ns["state"])
    gate_val = evaluate_expr(lines, line_num, tokens[1], ns)

    if len(tokens) < 3:
        first_target = 0
    else:
        first_target = evaluate_expr(lines, line_num, tokens[2], ns)
        _check_probval_type(lines, line_num, first_target, _INT_TYPES)

    if len(tokens) < 4:
        controls = []
    else:
        controls = _ensure_container(
            lines, line_num, evaluate_expr(lines, line_num, tokens[3], ns))

    if len(tokens) < 5:
        condition = True
    else:
        condition = evaluate_expr(lines, line_num, tokens[4], ns)
        _check_probval_type(lines, line_num, condition, bool)

    if not isinstance(condition, ProbVal) and not condition:
        return

    def _apply(g, first, ctrls):
        k = core.num_qubits(g)
        last = first + k - 1
        if first < 0 or last > n - 1:
            raise err.index_error(lines, line_num, "target", first, n - k)
        targets = list(range(first, first + k))
        ctrls = list(ctrls)
        for c in ctrls:
            if c < 0 or c > n - 1:
                raise err.index_error(lines, line_num, "control", c, n - 1)
            if first <= c <= last:
                raise err.control_target_overlap(lines, line_num, c, first, last)
        return core.apply_controlled(ns["state"], g, targets, ctrls,
                                     xp=backend.xp())

    try:
        applied = lift(_apply, gate_val, first_target, controls)
    except err.QbotScriptError:
        raise
    except Exception as e:
        raise err.python_error(lines, line_num, e) from e

    if isinstance(applied, ProbVal):
        applied = applied.to_density_matrix()

    if isinstance(condition, ProbVal):
        if condition.values[0]:
            applied = core.mix_densities(condition.probs, [applied, ns["state"]])
        else:
            applied = core.mix_densities(condition.probs, [ns["state"], applied])

    set_val(ns, lines, line_num, "state", applied)


def op_swap(ns, lines, line_num, tokens):
    n = hilbert_qubits(ns["state"])
    a = evaluate_expr(lines, line_num, tokens[1], ns)
    b = evaluate_expr(lines, line_num, tokens[2], ns)
    _check_probval_type(lines, line_num, a, _INT_TYPES)
    _check_probval_type(lines, line_num, b, _INT_TYPES)

    _SWAP2 = np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)

    def _swap(qa, qb):
        for q in (qa, qb):
            if q < 0 or q >= n:
                raise err.index_error(lines, line_num, "target", q, n - 1)
        if qa == qb:
            return ns["state"]
        return core.apply_gate_targets(ns["state"], _SWAP2, [qa, qb],
                                       xp=backend.xp())

    try:
        swapped = lift(_swap, a, b)
    except err.QbotScriptError:
        raise
    except Exception as e:
        raise err.python_error(lines, line_num, e) from e

    if isinstance(swapped, ProbVal):
        swapped = swapped.to_density_matrix()
    set_val(ns, lines, line_num, "state", swapped)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def op_meas(ns, lines, line_num, tokens, collapse=True):
    name = _var_name(lines, line_num, tokens[1])
    basis = evaluate_expr(lines, line_num, tokens[2], ns)
    if not isinstance(basis, Basis):
        raise err.type_error(lines, line_num, ["Basis"], type(basis).__name__)

    try:
        if len(tokens) < 4:
            result = measure(ns["state"], basis, None, collapse,
                             xp=backend.xp())
        else:
            targets = _ensure_container(
                lines, line_num, evaluate_expr(lines, line_num, tokens[3], ns))
            if isinstance(targets, ProbVal):
                result = lift(
                    lambda t: measure(ns["state"], basis, t, collapse,
                                      xp=backend.xp()), targets)
            else:
                result = measure(ns["state"], basis, targets, collapse,
                                 xp=backend.xp())
    except MeasurementIndexError as e:
        raise err.index_error(lines, line_num, "target", e.args[1], e.args[3]) from e
    except err.QbotScriptError:
        raise
    except Exception as e:
        raise err.python_error(lines, line_num, e) from e

    if isinstance(result, ProbVal):
        result = MeasurementResult.from_probval(result)

    ns[name] = result
    if collapse:
        set_val(ns, lines, line_num, "state", result.newState)


def op_peek(ns, lines, line_num, tokens):
    return op_meas(ns, lines, line_num, tokens, collapse=False)


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------

def op_jump(ns, lines, line_num, tokens):
    ns["__prev_jump"] = line_num
    return OpResult(jump_line=_mark_line(ns, lines, line_num, tokens[1]))


def op_cjmp(ns, lines, line_num, tokens):
    mark_line = _mark_line(ns, lines, line_num, tokens[1])
    cond = evaluate_expr(lines, line_num, tokens[2], ns)
    if isinstance(cond, ProbVal):
        # probabilistic branching of the interpreter itself is served by the
        # SMC ensemble runner (the JAX package's inference.smc), not by cjmp
        raise err.type_error(lines, line_num, ["bool"], cond.type_string())
    if not isinstance(cond, bool):
        raise err.type_error(lines, line_num, ["bool"], type(cond).__name__)
    if cond:
        ns["__prev_jump"] = line_num
        return OpResult(jump_line=mark_line)
    return None


def op_halt(ns, lines, line_num, tokens):
    if len(tokens) < 2:
        return OpResult(halt=True)
    val = evaluate_expr(lines, line_num, tokens[1], ns)
    if isinstance(val, bool):
        return OpResult(halt=val)
    got = val.type_string() if isinstance(val, ProbVal) else type(val).__name__
    raise err.type_error(lines, line_num, ["bool"], got)


def op_retr(ns, lines, line_num, tokens):
    if len(tokens) < 2:
        return OpResult(jump_line=ns["__prev_jump"] + 1)
    val = evaluate_expr(lines, line_num, tokens[1], ns)
    if isinstance(val, bool):
        if val:
            return OpResult(jump_line=ns["__prev_jump"] + 1)
        return None
    got = val.type_string() if isinstance(val, ProbVal) else type(val).__name__
    raise err.type_error(lines, line_num, ["bool"], got)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def op_pydo(ns, lines, line_num, tokens):
    evaluate_expr(lines, line_num, tokens[1], ns)


def op_cout(ns, lines, line_num, tokens):
    print(evaluate_expr(lines, line_num, tokens[1], ns))


# opcode -> (function, min_args, max_args); reference dispatch table parity
# (operators.py:477-506)
OPERATIONS = {
    "cdef": (op_cdef, 2, 2),
    "qdef": (op_qdef, 2, 2),
    "qset": (op_qset, 1, 2),
    "gate": (op_gate, 1, 4),
    "disc": (op_disc, 1, 1),
    "swap": (op_swap, 2, 2),
    "meas": (op_meas, 2, 3),
    "peek": (op_peek, 2, 3),
    "jump": (op_jump, 1, 1),
    "cjmp": (op_cjmp, 2, 2),
    "halt": (op_halt, 0, 1),
    "retr": (op_retr, 0, 1),
    "pydo": (op_pydo, 1, 1),
    "cout": (op_cout, 1, 1),
}
