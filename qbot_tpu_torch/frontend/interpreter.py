"""Program runtime: tokenizer, mark pre-pass, and the line interpreter.

Capability parity with the reference's ``qbot/interpreter.py``
(qbot/interpreter.py:71-235), including the observable
tokenizer quirks: the opcode is *exactly the first four characters* of the
stripped line, lowercased (so ``coutx`` parses as ``cout x``), operands are
``;``-separated with empty segments dropped, and marks are recorded in a
pre-pass over the whole program regardless of reachability.

The returned namespace is the public observable-state contract: ``state``
is the final density matrix, user variables sit at top level
(SURVEY.md §3.5).
"""
from __future__ import annotations

import time

import qbot_tpu_torch.errors as err
from qbot_tpu_torch.frontend.operations import OPERATIONS, OpResult
from qbot_tpu_torch.ops.core import empty_state
from qbot_tpu_torch.utils import profiling

__all__ = ["tokenize_line", "peek_opcode", "record_marks", "run_lines",
           "execute_lines", "executeTxt", "executeFile"]

OPCODE_WIDTH = 4


def peek_opcode(line: str) -> str:
    """Opcode of a line (first 4 stripped chars, lowercased)."""
    return line.strip()[:OPCODE_WIDTH].lower()


def tokenize_line(line: str) -> list[str]:
    """[opcode, operand1, operand2, ...] or [] for blank lines."""
    line = line.strip()
    if not line:
        return []
    tokens = [line[:OPCODE_WIDTH].lower()]
    for part in line[OPCODE_WIDTH:].split(";"):
        part = part.strip()
        if part:
            tokens.append(part)
    return tokens


def record_marks(ns: dict, lines: list[str]) -> None:
    """Pre-pass: record every ``mark NAME`` into ``__marks`` before execution."""
    for line_num, line in enumerate(lines):
        if peek_opcode(line) == "mark":
            tokens = tokenize_line(line)
            name = tokens[1] if len(tokens) > 1 else ""
            if not name.isidentifier():
                raise err.invalid_mark_name(lines, line_num, name)
            ns["__marks"][name] = line_num


def run_lines(ns: dict, lines: list[str], start_line: int = 0,
              end_line: int = -1) -> None:
    """Drive the program counter over ``lines`` (end_line exclusive)."""
    start_line = max(start_line, 0)
    if end_line == -1 or end_line > len(lines):
        end_line = len(lines)

    line_num = start_line - 1
    while line_num != end_line - 1 and line_num < len(lines) - 1:
        line_num += 1
        tokens = tokenize_line(lines[line_num])
        if not tokens:
            continue
        op_name = tokens[0]
        if op_name in ("note", "mark"):
            continue

        try:
            op, min_args, max_args = OPERATIONS[op_name]
        except KeyError:
            raise err.unknown_operation(lines, line_num, op_name) from None

        num_args = len(tokens) - 1
        if num_args < min_args or num_args > max_args:
            raise err.num_arguments_error(lines, line_num, op_name, num_args,
                                          min_args, max_args)

        if profiling.is_enabled():
            t0 = time.perf_counter()
            result: OpResult | None = op(ns, lines, line_num, tokens)
            profiling.record_line(line_num, op_name, time.perf_counter() - t0)
        else:
            result = op(ns, lines, line_num, tokens)
        if result is None:
            continue
        if result.halt:
            break
        if result.jump_line is not None:
            line_num = result.jump_line - 1


def execute_lines(lines: list[str]) -> dict:
    ns = {
        "state": empty_state(),
        "__updated_state": False,
        "__marks": {},
        "__prev_jump": -1,
    }
    record_marks(ns, lines)
    run_lines(ns, lines)
    return ns


def executeTxt(text: str) -> dict:
    """Execute .qb source text; returns the final namespace."""
    return execute_lines(text.splitlines())


def executeFile(file) -> dict:
    """Execute an open .qb file; returns the final namespace."""
    return execute_lines(file.readlines())
