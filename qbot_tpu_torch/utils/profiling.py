"""Per-line wall-time profiling of the dense host interpreter.

Copy of the host line timer of :mod:`qbot_tpu.utils.profiling`: a cheap
per-line wall/op report owned by the interpreter (which already owns line
numbers).  The device trace (:func:`device_trace`, :func:`named_scope`,
``qbot_tpu/utils/profiling.py:51-61``) is ``torch.profiler``'s.
"""
from __future__ import annotations

import contextlib
import os
from collections import defaultdict

import torch

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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace a region with ``torch.profiler`` and write its Chrome trace
    (``*.pt.trace.json``, which TensorBoard reads) into ``log_dir``; yields
    the profiler, whose ``key_averages()`` tables the region.  The card's
    activity is traced when there is a card, the host's always."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def named_scope(name: str):
    """A named range of the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
