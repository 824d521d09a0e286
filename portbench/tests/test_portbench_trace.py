"""The roofline's bounds on a hand-built plan, and the trace's busy, kernel
and idle arithmetic on synthetic profiler events, through the metric
readers."""
from __future__ import annotations

import json
from dataclasses import dataclass

import pytest

from portbench import bounds, run, trace
from portbench.run import Record


@dataclass
class WindowStep:
    start: int
    width: int


@dataclass
class PairStep:
    first: WindowStep
    second: WindowStep


@dataclass
class ReflectStep:
    factors: tuple = ()


@dataclass
class FlipStep:
    index: int = 0


@dataclass
class MysteryStep:
    pass


@dataclass
class Plan:
    n: int
    steps: list


N = 20
AMPS = 2 ** N
BYTES_S = 16 * AMPS / 3.35e12          # a state read and written once


def test_window_bounds():
    # D = 128, f32: 8·128 FLOPs an amplitude as 3 TF32 products each
    ops_s = 3 * 8 * 128 * AMPS / 495e12
    assert ops_s > BYTES_S
    assert bounds.step_bound_s(WindowStep(13, 7), N, "f32") == \
        pytest.approx(ops_s)
    # bf16 products of D = 128 and an FMA window of D = 4 are bytes-bound
    assert bounds.step_bound_s(WindowStep(13, 7), N, "bf16") == \
        pytest.approx(BYTES_S)
    assert bounds.step_bound_s(WindowStep(0, 2), N, "f32") == \
        pytest.approx(BYTES_S)
    # f32_mix runs the f32 tile
    assert bounds.step_bound_s(WindowStep(13, 7), N, "f32_mix") == \
        pytest.approx(ops_s)


def test_pair_and_other_bounds():
    pair = PairStep(WindowStep(6, 7), WindowStep(13, 7))
    assert bounds.step_bound_s(pair, N, "f32") == \
        pytest.approx(3 * 8 * 256 * AMPS / 495e12)
    assert bounds.step_bound_s(ReflectStep(), N, "f32") == \
        pytest.approx(BYTES_S)
    assert bounds.step_bound_s(FlipStep(), N, "f32") == \
        pytest.approx(16 / 3.35e12)
    with pytest.raises(ValueError, match="MysteryStep"):
        bounds.step_bound_s(MysteryStep(), N, "f32")


def test_plan_bound_is_the_sum_of_its_steps():
    plan = Plan(N, [WindowStep(0, 2), PairStep(WindowStep(2, 4),
                                               WindowStep(6, 7)),
                    ReflectStep()])
    want = sum(bounds.step_bound_s(s, N, "f32") for s in plan.steps)
    assert bounds.plan_bound_s(plan, "f32") == pytest.approx(want)
    assert bounds.fill_bound_s(N) == pytest.approx(8 * AMPS / 3.35e12)
    assert bounds.probs_bound_s(N) == pytest.approx(12 * AMPS / 3.35e12)


def _events():
    """A 1000 µs window: kernels at 100-200 and 150-300 (overlapping),
    500-600 and 950-1100 (cut at the window's end), a copy at 700-750,
    a kernel before the window; a PyTorch operation at 300-500 inside the
    harness span ``run``."""
    def ev(cat, name, ts, dur, tid=1):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    return [
        ev("user_annotation", "window", 0, 1000),
        ev("user_annotation", "run", 0, 1000),
        ev("kernel", "k_a", 100, 100, 7), ev("kernel", "k_b", 150, 150, 7),
        ev("kernel", "k_a", 500, 100, 7), ev("kernel", "k_c", 950, 150, 7),
        ev("kernel", "k_old", -500, 100, 7),
        ev("gpu_memcpy", "Memcpy DtoH", 700, 50, 8),
        ev("cpu_op", "aten::foo", 300, 200),
        ev("cpu_op", "aten::other_thread", 300, 700, 2),
    ]


def test_summary_busy_kernel_and_gaps():
    s = trace.summarize(_events(), "window", ("run",))
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(400e-6)
    assert s.kernel_s == pytest.approx(400e-6)
    assert s.device_ops[0] == ["k_a", pytest.approx(200e-6)]
    assert [g[0] for g in s.idle_gaps[:2]] == ["run:aten::foo", "run"]
    assert [g[1] for g in s.idle_gaps] == pytest.approx(
        [200e-6, 200e-6, 100e-6, 100e-6])


def test_read_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    assert trace.read(str(path), "window", ("run",)).busy_s == \
        pytest.approx(400e-6)


def test_metric_readers():
    s = trace.summarize(_events(), "window", ("run",))
    rec = Record(runs=4, work={"gates": 400}, window_s=2.0, bound_s=50e-6,
                 launches={"window_apply": 6, "pair_apply": 2},
                 parts={"compile_s": 0.5}, trace=s)
    read = {name: run.load_reader(name)(rec) for name in (
        "kernel_roofline.brickwork", "mfu.brickwork",
        "device_idle.brickwork", "launches_per_run.brickwork",
        "compile_s.sv", "gates_per_s.brickwork", "samples_per_s",
        "lower_s.ens")}
    assert read["kernel_roofline.brickwork"] == pytest.approx(50.0)
    assert read["mfu.brickwork"] == pytest.approx(20.0)
    assert read["device_idle.brickwork"] == pytest.approx(60.0)
    assert read["launches_per_run.brickwork"] == 2.0
    assert read["compile_s.sv"] == 0.5
    assert read["gates_per_s.brickwork"] == 200.0
    assert read["samples_per_s"] is None and read["lower_s.ens"] is None


def test_a_metric_of_many_cells_shares_one_reader():
    """``device_idle.ens`` and ``device_idle.grover`` are read by
    ``metrics/device_idle.py``; a name with a file of its own keeps it."""
    assert run.reader_path("device_idle.ens") == \
        run.reader_path("device_idle.grover") == \
        run.PKG / "metrics" / "device_idle.py"
    assert run.reader_path("samples_per_s.exact") == \
        run.PKG / "metrics" / "samples_per_s.py"
    assert run.reader_path("setup_s") == run.PKG / "metrics" / "setup_s.py"


def test_run_quartiles():
    assert run.run_quartiles([0.5]) == "0.5000"
    assert run.run_quartiles([1.0, 2.0, 3.0, 4.0, 5.0]) == \
        "1.0000 1.5000 3.0000 4.5000 5.0000"


def test_readers_find_nothing_without_a_device_trace():
    """A trace with no device activity (a CPU run) gives no roofline, no
    share of the peak and no idle share: nothing, never 0."""
    events = [e for e in _events() if e["cat"] not in trace.DEVICE_CATS]
    rec = Record(runs=4, bound_s=50e-6, work={"samples": 8},
                 trace=trace.summarize(events, "window", ("run",)))
    for name in ("kernel_roofline.brickwork", "mfu.brickwork",
                 "device_idle.brickwork", "device_idle.ens",
                 "kernel_ms_per_sample.ens"):
        assert run.load_reader(name)(rec) is None, name
