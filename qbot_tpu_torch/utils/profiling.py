"""Per-line wall-time profiling of the dense host interpreter.

Copy of the host line timer of :mod:`qbot_tpu.utils.profiling`: a cheap
per-line wall/op report owned by the interpreter (which already owns line
numbers).  Device traces of the port are ``torch.profiler``'s
(``chip_smoke.py --profile``).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

_enabled = False
_line_stats: dict[tuple[int, str], list[float]] = defaultdict(list)


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def profiling_enabled():
    """Enable per-line timing for the duration of the context."""
    global _enabled
    _enabled = True
    _line_stats.clear()
    try:
        yield
    finally:
        _enabled = False


def record_line(line_num: int, opcode: str, seconds: float) -> None:
    if _enabled:
        _line_stats[(line_num, opcode)].append(seconds)


def line_profile_report() -> str:
    """Human-readable per-line execution report (hits, total, mean)."""
    rows = ["line  op    hits   total(s)    mean(s)"]
    for (line_num, opcode), times in sorted(_line_stats.items()):
        total = sum(times)
        rows.append(f"{line_num:>4}  {opcode:<4} {len(times):>6} "
                    f"{total:>10.6f} {total / len(times):>10.6f}")
    return "\n".join(rows)
