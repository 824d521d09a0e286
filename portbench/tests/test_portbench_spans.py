"""The readers of the program's spans and counters
(``metrics/prep_ms_per_run.py``, ``sync_wait_ms_per_run.py``,
``host_syncs_per_run.py``, ``h2d_mib_per_run.py``): each reads the table of
the program's spans, or its counts made while they were on, over the
window's runs, and gives nothing without a trace, without the data, or from
a program that has no such table.  And the labels the program's spans give
the idle gaps once their names are among ``trace.summarize``'s spans, with
busy, kernel and window seconds as before."""
from __future__ import annotations

import pytest

from portbench import run, trace
from portbench.run import Record
from qbot_tpu_torch.utils import profiling

READERS = ("prep_ms_per_run.ens", "prep_ms_per_run.grover",
           "sync_wait_ms_per_run.ens", "host_syncs_per_run.ens",
           "h2d_mib_per_run.ens", "h2d_mib_per_run.grover")
SPANS = {"qbot.ensemble": {"total_s": 3.0, "self_s": 0.2, "calls": 4},
         "qbot.ensemble.init": {"total_s": 0.4, "self_s": 0.4, "calls": 4},
         "qbot.ensemble.compile": {"total_s": 0.2, "self_s": 0.2,
                                   "calls": 12},
         "qbot.plan.prepare": {"total_s": 0.6, "self_s": 0.6, "calls": 12},
         "qbot.sync": {"total_s": 1.2, "self_s": 1.2, "calls": 36}}
COUNTS = {"host_syncs": 136, "h2d_bytes": 4 * 129 * 2 ** 20}


def _events():
    """A 1000 µs window inside the harness span ``ensemble_run``: kernels
    at 100-300 and 700-800; the program's ``qbot.plan.prepare`` at
    300-600 around a PyTorch operation at 350-450."""
    def ev(cat, name, ts, dur, tid=1):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    return [
        ev("user_annotation", "window", 0, 1000),
        ev("user_annotation", "ensemble_run", 0, 1000),
        ev("user_annotation", "qbot.ensemble", 50, 900),
        ev("user_annotation", "qbot.plan.prepare", 300, 300),
        ev("kernel", "k_a", 100, 200, 7), ev("kernel", "k_b", 700, 100, 7),
        ev("cpu_op", "aten::copy_", 350, 100),
    ]


@pytest.fixture
def tables(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: SPANS)
    monkeypatch.setattr(profiling, "span_counts", lambda: COUNTS)


def _record(**kw):
    summary = trace.summarize(_events(), "window", run.SPANS)
    return Record(runs=4, trace=summary, **kw)


def test_readers_read_the_programs_tables(tables):
    read = {name: run.load_reader(name)(_record()) for name in READERS}
    assert read["prep_ms_per_run.ens"] == pytest.approx(300.0)
    assert read["prep_ms_per_run.grover"] == pytest.approx(300.0)
    assert read["sync_wait_ms_per_run.ens"] == pytest.approx(300.0)
    assert read["host_syncs_per_run.ens"] == 34.0
    assert read["h2d_mib_per_run.ens"] == pytest.approx(129.0)


def test_readers_find_nothing_without_a_trace(tables):
    for name in READERS:
        assert run.load_reader(name)(Record(runs=4)) is None, name


def test_readers_find_nothing_in_empty_tables(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    monkeypatch.setattr(profiling, "span_counts", lambda: {})
    for name in READERS:
        assert run.load_reader(name)(_record()) is None, name


def test_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "span_totals")
    monkeypatch.delattr(profiling, "span_counts")
    for name in READERS:
        assert run.load_reader(name)(_record()) is None, name


def test_program_spans_label_the_gaps():
    """Given the program's span names, the gap at 300-700 reads as the
    innermost one, the others as before; the seconds do not move."""
    events = _events()
    harness = trace.summarize(events, "window", run.SPANS)
    names = run.SPANS + ("qbot.ensemble", "qbot.plan.prepare")
    program = trace.summarize(events, "window", names)
    assert harness.idle_gaps[0] == ["ensemble_run", pytest.approx(400e-6)]
    assert program.idle_gaps[0] == ["qbot.plan.prepare",
                                    pytest.approx(400e-6)]
    assert [g[0] for g in program.idle_gaps[1:]] == [
        "qbot.ensemble", "qbot.ensemble"]
    for field in ("window_s", "busy_s", "kernel_s", "device_ops"):
        assert getattr(program, field) == getattr(harness, field), field
