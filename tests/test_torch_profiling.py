"""The port's spans and counters (:mod:`qbot_tpu_torch.utils.profiling`).

Spans off by default cost one shared no-op context and record nothing,
while counters count; with spans on, nesting, self time and call numbers
(``perf_counter`` stubbed); the spans of a traced call land inside the
caller's enclosing ``record_function`` range of a ``torch.profiler``
trace, so they share its clock; ``run_lowered_ensemble`` on an 8-qubit
copy of the benchmark's SMC program opens each of its spans, one compile a
segment and rotation, and counts its uploads and host reads; the scanned
runner's spans; ``launch_counts`` and ``product_counts`` as before, views
of the one table; the mesh's ``phase_walls`` from the spans.

The card test (``cuda`` marker; ``python -m pytest --noconftest -m cuda
tests/test_torch_profiling.py``) holds ``host_syncs`` to every sync that
``torch.cuda.set_sync_debug_mode("warn")`` reports.

Tolerance: none (counts are exact; stubbed seconds are sums of small
integers).
"""
import json
import warnings

import numpy as np
import pytest
import torch

from portbench.families import brickwork, grover
from portbench.families.smc_program import smc_program
from qbot_tpu_torch.frontend import lowering
from qbot_tpu_torch.tpu import compiler, dotplan, kernels, planar
from qbot_tpu_torch.tpu.circuit import Circuit
from qbot_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 8
SAMPLE = 8
SEGMENTS = 3          # the program's segments with gates (before a, b, disc)
COLLAPSES = 4         # meas a, meas b, disc, meas c
READOUTS = 3
# host reads a sampled run waits on: an ESS after each collapse and each
# readout, and the discard's torch.nonzero for each of its 2 outcomes
READS = COLLAPSES + READOUTS + 2


@pytest.fixture
def spans():
    """Spans on, their table empty, for the test."""
    profiling.reset_spans()
    with profiling.tracing():
        yield
    profiling.reset_spans()


@pytest.fixture
def clock(monkeypatch):
    """``perf_counter`` of the spans stubbed: each reading advances 1 s
    unless the test set the next readings."""
    ticks = []
    now = [0.0]

    def fake():
        now[0] = ticks.pop(0) if ticks else now[0] + 1.0
        return now[0]
    monkeypatch.setattr(profiling, "_now", fake)
    return ticks


def _program(n=N, rotate=False):
    rng = np.random.default_rng(5)
    text, _ = smc_program(n, iter(rng.uniform(0.8, 2.3, size=4 * n)))
    if rotate:
        text = text.replace("meas a ; computation", "meas a ; hadamard")
    return lowering.lower_program(text, mid_measure=True)


def _spans_on() -> bool:
    return profiling.named_scope("probe") is not profiling.named_scope("x")


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def test_spans_off_cost_one_shared_context_and_record_nothing():
    profiling.reset_spans()
    assert not _spans_on()
    assert profiling.named_scope("a") is profiling.named_scope("b", 3)
    call = profiling.call_number()
    before = profiling.counters()
    with profiling.named_scope("qbot.off"):
        profiling.count("test.off", 2)
    with profiling.sync():
        pass
    assert profiling.span_totals() == {} and profiling.span_counts() == {}
    assert profiling.call_number() == call
    got = _delta(before, profiling.counters())
    assert got["test.off"] == 2 and got["host_syncs"] == 1


def test_nesting_self_time_and_call_numbers(spans, clock):
    call = profiling.call_number()
    clock.extend([0.0, 2.0, 5.0, 6.0, 7.0, 10.0])
    with profiling.named_scope("outer"):                 # 0 .. 10
        assert profiling.call_number() == call + 1
        with profiling.named_scope("inner"):             # 2 .. 5
            assert profiling.call_number() == call + 1
            profiling.count("test.on", 3)
        with profiling.named_scope("inner", "second"):   # 6 .. 7
            pass
    clock.extend([20.0, 24.0])
    with profiling.named_scope("outer"):                 # 20 .. 24
        assert profiling.call_number() == call + 2
    assert profiling.span_totals() == {
        "outer": {"total_s": 14.0, "self_s": 10.0, "calls": 2},
        "inner": {"total_s": 4.0, "self_s": 4.0, "calls": 2}}
    assert profiling.span_counts() == {"test.on": 3}
    profiling.reset_spans()
    assert profiling.span_totals() == {} and profiling.span_counts() == {}


def test_spanned_and_host_float(spans, clock):
    clock.extend([0.0, 1.0, 3.0, 4.0])

    @profiling.spanned("qbot.test")
    def read(x):
        return profiling.host_float(x)
    before = profiling.counters()
    assert read(torch.tensor(2.5)) == 2.5
    assert read.__name__ == "read"
    assert profiling.span_totals() == {
        "qbot.test": {"total_s": 4.0, "self_s": 2.0, "calls": 1},
        "qbot.sync": {"total_s": 2.0, "self_s": 2.0, "calls": 1}}
    assert profiling.host_float(1.5) == 1.5          # no tensor: no read
    assert _delta(before, profiling.counters())["host_syncs"] == 1


def test_upload_counts_bytes_and_one_sync():
    before = profiling.counters()
    t = profiling.upload(np.arange(6, dtype=np.float32).reshape(2, 3), "cpu")
    e = profiling.upload(np.zeros(0, np.int64), "cpu")
    assert t.dtype == torch.float32 and t.shape == (2, 3)
    assert e.dtype == torch.int64 and e.numel() == 0
    got = _delta(before, profiling.counters())
    assert got["h2d_bytes"] == 24 and got["host_syncs"] == 1


def test_spans_share_the_profilers_clock(tmp_path):
    """Under a profiler of the caller's own (no ``tracing()``), the scanned
    runner's spans are ``user_annotation`` ranges inside the caller's
    enclosing range."""
    req = grover.build({"qubits": 6}, {"repeats": 3}, 11)
    plan = compiler.compile_circuit(_circuit(6, req.body_ops), window=4)
    init = compiler.compile_circuit(_circuit(6, req.init_ops), window=4)
    run = planar.make_scanned_planar_runner(plan, req.repeats,
                                            init_plan=init)
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window"):
            assert _spans_on()
            run(planar.zero_state_planar(6, "cpu"))
    assert not _spans_on()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (window,) = [e for e in events if e["name"] == "window"]
    ours = [e for e in events if e["name"].startswith("qbot.")]
    assert sorted({e["name"] for e in ours}) == [
        "qbot.plan.apply", "qbot.plan.prepare", "qbot.scan"]
    for e in ours:
        assert window["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= window["ts"] + window["dur"]
    assert profiling.span_totals()["qbot.scan"]["calls"] == 1
    profiling.reset_spans()


def test_device_trace_turns_spans_on(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        assert _spans_on()
    assert not _spans_on()


def _circuit(n, ops):
    c = Circuit(n)
    for op in ops:
        if op[0] == "flip":
            c.phase_flip(op[1])
        else:
            c.gate(op[2], list(op[1]), list(op[3]))
    return c


@pytest.mark.parametrize("name,traffic,spans_a_run", [
    ("brickwork", {"layers": 4, "repeats": 3}, 2),
    ("grover", {"repeats": 4}, 4)])
def test_scanned_runner_spans(spans, name, traffic, spans_a_run):
    """A brickwork run opens ``qbot.scan`` and one ``qbot.plan.apply``
    around all its bodies; Grover's also its init plan's apply and the
    reflection's tables (``qbot.plan.prepare``); the zero state's host
    scalar is one host sync."""
    n = 8
    family = {"brickwork": brickwork, "grover": grover}[name]
    req = family.build({"qubits": n}, traffic, 3)
    plan = compiler.compile_circuit(_circuit(n, req.body_ops), window=4)
    init = (compiler.compile_circuit(_circuit(n, req.init_ops), window=4)
            if req.init_ops else None)
    run = planar.make_scanned_planar_runner(plan, req.repeats,
                                            init_plan=init)
    run(planar.zero_state_planar(n, "cpu"))           # prepares the plans
    profiling.reset_spans()
    before = profiling.counters()
    for _ in range(2):
        run(planar.zero_state_planar(n, "cpu"))
    totals = profiling.span_totals()
    assert sum(t["calls"] for t in totals.values()) == 2 * spans_a_run
    assert totals["qbot.scan"]["calls"] == 2
    assert totals["qbot.plan.apply"]["calls"] == 2 * (1 + (init is not None))
    got = _delta(before, profiling.counters())
    if family is grover:
        # the reflection's five tables (head, tail, lane, flips' shifts,
        # flips) each run, the head's planes 2 × 2 floats at least
        assert got["h2d_bytes"] >= 2 * (2 * 2 * 4)
        assert got["host_syncs"] == 2 * (1 + 5)
    else:
        assert got.get("h2d_bytes", 0) == 0 and got["host_syncs"] == 2


@pytest.fixture
def uploads(monkeypatch):
    """The uploads that move bytes, as (bytes, ...) recorded."""
    seen = []
    real = profiling.upload

    def spy(array, device):
        if array.nbytes:
            seen.append(array.nbytes)
        return real(array, device)
    monkeypatch.setattr(profiling, "upload", spy)
    return seen


@pytest.mark.parametrize("rotate", [False, True])
def test_ensemble_spans_and_counters(spans, uploads, rotate):
    """Two sampled runs of the 8-qubit program: every span of the call,
    one compile a segment and a rotation, a readout a measurement, an ESS
    read a collapse; ``h2d_bytes`` holds the planar ket once (the first
    run builds the initial state, the second reuses it), and
    ``host_syncs`` the reads plus the uploads."""
    lp = _program(rotate=rotate)
    before = profiling.counters()
    calls = profiling.call_number()
    h2d = []
    for seed in (1, 2):
        start = profiling.counters().get("h2d_bytes", 0)
        lowering.run_lowered_ensemble(lp, window=7, sample=SAMPLE, seed=seed,
                                      device="cpu")
        h2d.append(profiling.counters()["h2d_bytes"] - start)
    assert profiling.call_number() == calls + 2
    got = _delta(before, profiling.counters())
    calls_of = {k: v["calls"] for k, v in profiling.span_totals().items()}
    assert calls_of == {
        "qbot.ensemble": 2, "qbot.ensemble.init": 2,
        "qbot.ensemble.compile": 2 * (SEGMENTS + rotate),
        "qbot.plan.prepare": 2 * (SEGMENTS + 2 * rotate),
        "qbot.plan.apply": 2 * (SEGMENTS + 2 * rotate),
        "qbot.ensemble.collapse": 2 * COLLAPSES,
        "qbot.ensemble.readout": 2 * READOUTS,
        "qbot.ensemble.epilogue": 2, "qbot.sync": 2 * READS}
    if not rotate:                    # the benchmark's program: < 30 a call
        assert sum(calls_of.values()) < 2 * 30
    assert h2d[0] >= 2 * 2**N * 4
    assert h2d[1] == h2d[0] - 2 * 2**N * 4
    assert got["h2d_bytes"] == sum(uploads)
    assert got["host_syncs"] == 2 * READS + len(uploads)
    assert got["init_state_builds"] == got["init_state_reuses"] == 1
    assert profiling.span_counts() == {
        k: got[k] for k in ("h2d_bytes", "host_syncs", "init_state_builds",
                            "init_state_reuses")}


def test_exact_fanout_reads(spans):
    """The exact fan-out reads a ``torch.nonzero`` per branch block (K² a
    measurement in reference mode, K a discard), a readout a measurement
    and the pruned mass once."""
    lp = _program()
    lowering.run_lowered_ensemble(lp, window=7, sample=0, device="cpu")
    totals = profiling.span_totals()
    assert totals["qbot.sync"]["calls"] == (4 + 4 + 2 + 16) + READOUTS + 1
    assert totals["qbot.ensemble.collapse"]["calls"] == COLLAPSES


def test_launch_and_product_counts_keep_their_form():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTS, 0)
    assert list(kernels.launch_counts()) == list(kernels.LAUNCH_COUNTS)
    kernels._count("window_apply")
    kernels._count("reflect_dot")
    want = dict.fromkeys(kernels.LAUNCH_COUNTS, 0)
    want.update(window_apply=1, reflect_dot=1)
    assert kernels.launch_counts() == want
    assert profiling.counters()["window_apply"] == 1
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["window_apply"] == 0
    dotplan.reset_product_counts()
    assert dotplan.product_counts() == {}
    profiling.count("h2d_bytes", 8)            # other keys stay out
    dotplan._products["dot_window[bf16]"] = 2
    assert dotplan.product_counts() == {"dot_window[bf16]": 2}
    dotplan.reset_product_counts()
    assert dotplan.product_counts() == {}
    assert "h2d_bytes" in profiling.counters()


def test_mesh_phase_walls_come_from_the_spans():
    """A 1 x 1 mesh in this process: ``stats["phase_walls"]`` holds each
    phase's span seconds with spans on, and nothing with them off."""
    lp = _program()
    stats = {}
    lowering.run_lowered_sharded_ensemble(lp, sample=SAMPLE, stats=stats,
                                          device="cpu")
    assert "phase_walls" not in stats and stats["collapse_events"] == 4
    profiling.reset_spans()
    stats = {}
    with profiling.tracing():
        lowering.run_lowered_sharded_ensemble(lp, sample=SAMPLE,
                                              stats=stats, device="cpu")
    totals = profiling.span_totals()
    walls = stats["phase_walls"]
    assert set(walls) == {"init", "segment", "collapse", "exchange",
                          "fetch"}
    for name, seconds in walls.items():
        assert seconds == totals[f"qbot.ensemble.{name}"]["total_s"] > 0
    assert totals["qbot.ensemble.collapse"]["calls"] == COLLAPSES
    profiling.reset_spans()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smc", "exact", "grover"])
def test_host_syncs_count_every_sync_pytorch_reports(case):
    """Every sync ``torch.cuda.set_sync_debug_mode("warn")`` reports in a
    warm run is one ``host_syncs``, and no count is left without its
    sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if case == "grover":
        req = grover.build({"qubits": 12}, {"repeats": 4}, 3)
        plan = compiler.compile_circuit(_circuit(12, req.body_ops),
                                        window="auto")
        init = compiler.compile_circuit(_circuit(12, req.init_ops),
                                        window="auto")
        runner = planar.make_scanned_planar_runner(plan, req.repeats,
                                                   init_plan=init)

        def run():
            runner(planar.zero_state_planar(12, "cuda"))
    else:
        lp = _program(12)
        sample = SAMPLE if case == "smc" else 0

        def run():
            lowering.run_lowered_ensemble(lp, window=7, sample=sample,
                                          seed=3, device="cuda")
    run()
    torch.cuda.synchronize()
    before = profiling.counters().get("host_syncs", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    reported = [str(w.message) for w in caught
                if "called a synchronizing" in str(w.message)]
    assert profiling.counters()["host_syncs"] - before == len(reported), \
        reported
