"""The density-matrix cell's parts: the plain reference against a dense
4^n unitary conjugation, the thermal family's request, the density bound
on a plan worked by hand, the reader of the diagonal passes, and whole runs
of the cell cut to the CPU's size (sound, in a lower precision, with the
timed path broken underneath)."""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import bounds, control, density_bounds, faults, generator, \
    run
from portbench.entries import density as density_entry
from portbench.families import brickwork, thermal_brickwork
from portbench.reference import density
from portbench.tests._small import ROOT
from portbench.tests.test_portbench_reference import dense

WORKLOAD = "dm13-brickwork"


def small_spec() -> dict:
    """The cell at 8 qubits (a 16-qubit view: five (1, 7) pairs and four
    diagonal steps a body), its 8-layer body run 4 times."""
    spec = run.load_cell(ROOT, WORKLOAD)
    spec["config"]["qubits"] = 8
    spec["traffic"].update({"layers": 8, "repeats": 4})
    return spec


def measure(spec: dict, trace: bool = False) -> dict:
    return run.measure(spec, 2 ** 33 + 21, 0.05, trace, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("n", [3, 4])
def test_reference_against_a_dense_conjugation(n):
    """ρ0 = ⊗ρ_q, then UρU† for each op's dense 2^n unitary: 1-qubit
    gates, CX, a controlled 2-qubit gate on targets out of order and apart,
    a flip."""
    ops = brickwork.brickwork_ops(n, 2, seed=n)
    two = np.kron(brickwork.brickwork_ops(1, 1, 4)[0][2],
                  brickwork.brickwork_ops(1, 1, 5)[0][2])
    ops += [("gate", (n - 1, 0), two, (1,)), ("flip", 5),
            ("gate", (1,), two[:2, :2] * 0 + np.eye(2)[::-1], (n - 1,))]
    rng = np.random.default_rng(n)
    rhos = []
    for _ in range(n):
        a = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        rhos.append(a @ a.conj().T / np.trace(a @ a.conj().T))
    want = np.ones((1, 1), np.complex128)
    for r in rhos:
        want = np.kron(want, r)
    for _ in range(2):
        for op in ops:
            u = dense(n, op)
            want = u @ want @ u.conj().T
    req = thermal_brickwork.ThermalRequest("circuit", n, 0, body_ops=ops,
                                           repeats=2, rhos=rhos)
    got = density.simulate(req, "cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-13)


def test_thermal_request_repeats_from_the_seed():
    spec = run.load_cell(ROOT, WORKLOAD)
    a = generator.make_request(spec["config"], spec["traffic"], 2 ** 33 + 5)
    b = generator.make_request(spec["config"], spec["traffic"], 2 ** 33 + 5)
    c = generator.make_request(spec["config"], spec["traffic"], 2 ** 33 + 6)
    assert isinstance(a, thermal_brickwork.ThermalRequest)
    assert all(np.array_equal(x[2], y[2])
               for x, y in zip(a.body_ops, b.body_ops))
    assert all(np.array_equal(x, y) for x, y in zip(a.rhos, b.rhos))
    assert not np.array_equal(a.rhos[0], c.rhos[0])
    assert not np.array_equal(a.body_ops[0][2], c.body_ops[0][2])
    assert len(a.rhos) == 13 and a.repeats == 16
    p = np.array([r[1, 1].real for r in a.rhos])
    assert np.all((p >= 0.01) & (p <= 0.10))
    for r, x in zip(a.rhos, p):
        np.testing.assert_array_equal(r, np.diag([1 - x, x]))
    assert a.per_run == {"gates": 152 * 16}


def _step(kind, **fields):
    """A plan step stand-in: the bound reads its class name and fields."""
    return type(kind, (SimpleNamespace,), {})(**fields)


def test_density_bound_of_a_plan_by_hand():
    """The 13-qubit body's shape: four (64, 128) pairs, each after a
    diagonal, and a 128-wide window, in f32: every step bound by its
    3×TF32 operations over both sides of 4^13 entries."""
    w6, w7 = _step("WindowStep", width=6), _step("WindowStep", width=7)
    pair = _step("PairStep", first=w6, second=w7)
    steps = [pair, *[s for _ in range(3) for s in
                     (_step("DiagStep"), pair)], w7]
    plan = SimpleNamespace(n=13, steps=steps)
    entries = 4 ** 13
    pair_s = 3 * 2 * 8 * (64 + 128) * entries / 495e12
    window_s = 3 * 2 * 8 * 128 * entries / 495e12
    assert pair_s == pytest.approx(1.24945e-3, rel=1e-5)
    got = density_bounds.plan_bound_s(plan, "f32")
    assert got == pytest.approx(4 * pair_s + window_s, rel=1e-12)
    # a byte-bound step: a 1-qubit window, 16 bytes an entry
    assert density_bounds.step_bound_s(_step("WindowStep", width=1), 13,
                                       "f32") == pytest.approx(
        16 * entries / bounds.HBM_BYTES_S, rel=1e-12)
    assert density_bounds.fill_bound_s(13) == pytest.approx(
        8 * entries / bounds.HBM_BYTES_S, rel=1e-12)
    assert density_bounds.readout_bound_s(13) == pytest.approx(
        12 * 2 ** 13 / bounds.HBM_BYTES_S, rel=1e-12)
    with pytest.raises(ValueError):
        density_bounds.step_bound_s(_step("ReflectStep"), 13, "f32")


def test_diag_pass_reader(monkeypatch):
    from portbench import trace
    from qbot_tpu_torch.utils import profiling

    read = run.load_reader("diag_passes_per_run.density")
    summary = trace.Summary(window_s=1.0, busy_s=0.9, kernel_s=0.8)
    monkeypatch.setattr(profiling, "span_counts",
                        lambda: {"density_diag_passes": 4 * 128})
    assert read(run.Record(runs=4, trace=summary)) == 128.0
    assert read(run.Record(runs=4)) is None
    monkeypatch.setattr(profiling, "span_counts", lambda: {})
    assert read(run.Record(runs=4, trace=summary)) is None
    monkeypatch.delattr(profiling, "span_counts")
    assert read(run.Record(runs=4, trace=summary)) is None


def test_small_run_is_correct_and_counts_its_passes():
    result = measure(small_spec(), trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    # 8 qubits: four diagonal steps a body, two passes each, 4 bodies
    assert metrics["diag_passes_per_run.density"]["value"] == 32.0
    assert "launches_per_run.brickwork" in metrics
    assert "compile_s.sv" in metrics


def test_init_ops_are_refused():
    """The density entry starts from the request's factors alone."""
    spec = small_spec()
    req = generator.make_request(spec["config"], spec["traffic"], 3)
    req.init_ops = [("flip", 0)]
    entry = density_entry.Entry(spec["config"], req, "cpu", run.Span)
    with pytest.raises(ValueError):
        entry.setup({})


def test_program_within_the_limits():
    spec = small_spec()
    got = control.readings(spec, spec["config"]["precision"], 11, 0.05,
                           device="cpu")
    for name, value in got.items():
        assert value <= spec["limits"][name], (name, value)


@pytest.mark.parametrize("mode", ["tf32", "bf16_3x"])
def test_lower_precision_fails(mode):
    """The reference in the program's place in TF32, and the program's own
    bf16_3x windows and pairs."""
    spec = small_spec()
    got = control.readings(spec, mode, 11, 0.05, device="cpu")
    assert any(v > spec["limits"][k] for k, v in got.items()), got


def test_stale_step_fails(monkeypatch):
    faults.stale_step(monkeypatch.setattr)
    result = measure(small_spec())
    assert not result["correct"], result["checks"]


def test_control_outputs_are_planar_float32():
    spec = small_spec()
    req = generator.make_request(spec["config"], spec["traffic"], 3)
    out = density.control_outputs(req, "cpu", 3)
    assert out["state"].shape == (2, 256, 256)
    assert out["state"].dtype == torch.float32
    assert out["readouts"][0].shape == (256,)
