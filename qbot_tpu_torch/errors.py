"""Script error rendering.

Capability parity with the reference's ``qbot/errors.py``
(qbot/errors.py:8-71): every diagnostic renders a 5-line
source-context window with ``>>>`` marking the offending line and
zero-padded line numbers.

Deliberate behavioural fix (SURVEY.md §5): the reference *prints and
sys.exit()s* on every error even when embedded (errors.py:26-28).  Here
errors are real exceptions (``QbotScriptError``) that embedders can catch;
only the CLI converts them to an exit code.
"""
from __future__ import annotations

CONTEXT_LINES = 5

__all__ = [
    "QbotScriptError",
    "format_script_error",
    "unknown_operation",
    "invalid_variable_name",
    "invalid_mark_name",
    "unknown_mark_name",
    "num_arguments_error",
    "index_error",
    "control_target_overlap",
    "type_error",
    "size_error",
    "python_error",
]


class QbotScriptError(Exception):
    """A .qb script error with rendered source context."""

    def __init__(self, message: str, line_num: int | None = None,
                 error_name: str = "Error"):
        super().__init__(message)
        self.line_num = line_num
        self.error_name = error_name


def format_script_error(lines, line_num: int, error_name: str, info: str) -> str:
    msg = f"{error_name}: {info}"
    start = max(int(line_num - (CONTEXT_LINES - 1) / 2), 0)
    end = min(start + CONTEXT_LINES, len(lines))
    width = len(str(end - 1))
    for i in range(start, end):
        marker = ">>>" if i == line_num else "   "
        msg += f"\n{marker} {str(i).zfill(width)}: {lines[i]}"
    return msg


def _make(lines, line_num, name, info) -> QbotScriptError:
    return QbotScriptError(format_script_error(lines, line_num, name, info),
                           line_num, name)


def unknown_operation(lines, line_num, op):
    return _make(lines, line_num, "UnknownOperation", op)


def invalid_variable_name(lines, line_num, var_name):
    return _make(lines, line_num, "InvalidVariableName", var_name)


def invalid_mark_name(lines, line_num, mark_name):
    return _make(lines, line_num, "InvalidMarkName", mark_name)


def unknown_mark_name(lines, line_num, mark_name):
    return _make(lines, line_num, "UnknownMarkName", mark_name)


def num_arguments_error(lines, line_num, op, given, lo, hi=-1):
    if hi >= lo:
        info = f"operation {op} requires {lo}-{hi} arguments ({given} given)"
    else:
        info = f"operation {op} requires {lo} argument(s) ({given} given)"
    return _make(lines, line_num, "NumArgumentsError", info)


def index_error(lines, line_num, kind, index, max_index, min_index=0):
    return _make(lines, line_num, "IndexError",
                 f"{kind} index {index} outside of valid range "
                 f"[{min_index}, {max_index}]")


def control_target_overlap(lines, line_num, index, min_target, max_target):
    if min_target == max_target:
        info = f"control index {index} overlaps with target index {min_target}"
    else:
        info = (f"control index {index} overlaps with target indices "
                f"[{min_target}, {max_target}]")
    return _make(lines, line_num, "IndexError", info)


def type_error(lines, line_num, expected: list[str], got: str):
    want = f"any of {expected}" if len(expected) > 1 else expected[0]
    return _make(lines, line_num, "TypeError",
                 f"{got} cannot be interpreted as {want}")


def size_error(lines, line_num, info):
    return _make(lines, line_num, "SizeError", info)


def python_error(lines, line_num, e: Exception):
    return _make(lines, line_num, e.__class__.__name__, str(e))
