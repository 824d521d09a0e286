"""The port's spans and counters, and the dense interpreter's line timer.

**Spans** mark the phases of a call into the program (:func:`named_scope`,
names ``qbot.*``: preparation, the plan's launches, a collapse, a host read
that waits for the card).  They are off by default, and a span is then
one shared no-op context.  They come on inside :func:`tracing` and while a
``torch.profiler`` traces the process (:func:`device_trace`, or a
profiler of the caller's own): each span is then a
``torch.profiler.record_function`` range, so the Chrome trace shows it as a
``user_annotation`` on the clock of the card's kernels and copies, and it
adds its host seconds to an in-memory table (:func:`span_totals`: total,
self, calls).  A span's parent is the innermost span open; the outermost
span of a call takes the call's sequence number (:func:`call_number`) and
every span of the call passes it to its range.

**Counters** (:func:`count`, :func:`counters`) are always on: one table,
incremented where the program hands bytes to the card (``h2d_bytes``,
through :func:`upload`) and where the host waits for it (``host_syncs``,
through :func:`sync`, or beside an operation that synchronises inside
PyTorch).  The kernels' launch counts and the dot engine's product counts
live in the same table (``kernels.launch_counts``,
``dotplan.product_counts`` are views of it).  The counts made while spans
are on are kept apart as well (:func:`span_counts`), so a caller that
traces a window reads the window's counts alone.

No span sits on a kernel launch or a plan step's apply: spans mark phases,
a few dozen a call at most.  A counter may (a dictionary update): the
launch counts, and the density executor's elementwise passes.

**The line timer** (:func:`profiling_enabled`, :func:`record_line`, CLI
``--profile``): per-line wall time of the dense host interpreter, which
owns the line numbers.
"""
from __future__ import annotations

import contextlib
import functools
import os
from collections import defaultdict
from time import perf_counter as _now

import numpy as np
import torch

_enabled = False
_line_stats: dict[tuple[int, str], list[float]] = defaultdict(list)

# the one counter table: name -> count (kernels.py and dotplan.py increment
# their launch and product keys in it directly)
COUNTS: dict = {}
_span_counts: dict = {}
_spans: dict = {}          # name -> [total seconds, self seconds, calls]
_stack: list = []          # the open spans, innermost last
_tracing = 0               # depth of tracing() blocks
_call = 0                  # sequence number of the last call's outer span
_profiler_on = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


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


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tracing():
    """Spans on for the block (blocks nest)."""
    global _tracing
    _tracing += 1
    try:
        yield
    finally:
        _tracing -= 1


class _Span:
    """An open span: its ``record_function`` range and host clock."""
    __slots__ = ("name", "arg", "rf", "t0", "child")

    def __init__(self, name: str, arg):
        self.name, self.arg = name, arg

    def __enter__(self):
        global _call
        if not _stack:
            _call += 1
        args = str(_call) if self.arg is None else f"{_call} {self.arg}"
        self.rf = torch.profiler.record_function(self.name, args)
        self.rf.__enter__()
        self.child = 0.0
        _stack.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        seconds = _now() - self.t0
        _stack.pop()
        row = _spans.get(self.name)
        if row is None:
            row = _spans[self.name] = [0.0, 0.0, 0]
        row[0] += seconds
        row[1] += seconds - self.child
        row[2] += 1
        if _stack:
            _stack[-1].child += seconds
        return self.rf.__exit__(*exc)


def named_scope(name: str, arg=None):
    """The program's span ``name`` (``arg``, if given, joins the call's
    number in the range's argument); with spans off a shared no-op
    context."""
    if _tracing or _profiler_on():
        return _Span(name, arg)
    return _OFF


def spanned(name: str):
    """Decorator: the whole call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with named_scope(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def span_totals() -> dict:
    """``{name: {"total_s", "self_s", "calls"}}`` of the spans closed while
    spans were on, since the last :func:`reset_spans`; self time is the
    total less the time of the spans opened inside it."""
    return {name: {"total_s": t, "self_s": s, "calls": c}
            for name, (t, s, c) in _spans.items()}


def span_counts() -> dict:
    """The counts made while spans were on, since the last
    :func:`reset_spans`."""
    return dict(_span_counts)


def reset_spans() -> None:
    _spans.clear()
    _span_counts.clear()


def call_number() -> int:
    """The sequence number of the call in progress (of the last, between
    calls): one a span opened with no span open, while spans are on."""
    return _call


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTS[name] = COUNTS.get(name, 0) + n
    if _tracing or _profiler_on():
        _span_counts[name] = _span_counts.get(name, 0) + n


def counters() -> dict:
    """A copy of the counter table."""
    return dict(COUNTS)


def upload(array: np.ndarray, device) -> torch.Tensor:
    """The numpy ``array`` copied to ``device`` (a view of it on the CPU).
    Counts its bytes as ``h2d_bytes`` and, when it moves any, one host sync:
    PyTorch's blocking copy from pageable host memory waits for the card's
    stream to drain.  Both count on any device, so the CPU's counts are the
    card's."""
    t = torch.from_numpy(array).to(device)
    if array.nbytes:
        count("h2d_bytes", array.nbytes)
        count("host_syncs")
    return t


def sync():
    """The span ``qbot.sync`` of a host read the run waits on (``float`` or
    ``.cpu()`` of a device tensor, ``torch.nonzero`` on one); counts one
    ``host_syncs``: ``with profiling.sync(): x = float(t)``."""
    count("host_syncs")
    return named_scope("qbot.sync")


def host_float(x) -> float:
    """``float(x)``; of a tensor, a host read under :func:`sync`."""
    if isinstance(x, torch.Tensor):
        with sync():
            return float(x)
    return float(x)


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace a region with ``torch.profiler``, the program's spans on, and
    write its Chrome trace (``*.pt.trace.json``, which TensorBoard reads)
    into ``log_dir``; yields the profiler, whose ``key_averages()`` tables
    the region.  The card's activity is traced when there is a card, the
    host's always."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(), torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
